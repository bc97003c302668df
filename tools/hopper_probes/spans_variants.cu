// The per-token hashes (stringwars_tpu_torch/csrc/hash.cu) at other register
// budgets (blocks an SM the launch bounds ask for), kept for measurement
// only: tools/hopper_probes.py spans times them on the hash suite's tape and
// on 1 KiB lines. Nothing of the package calls them.
#include "../../stringwars_tpu_torch/csrc/hash.cu"

namespace {

bool whole_grid = false;  // a block a 256 tokens, not the package's resident grid

template <class Kernel, class Out>
void run(Kernel kernel, const uint8_t* data, int64_t end, const int64_t* offsets, const int32_t* lengths, int64_t width,
         int64_t count, const swt::Seeds& seeds, Out out, cudaStream_t stream) {
  const int64_t want = (count + swt::kThreads - 1) / swt::kThreads;
  const int grid = whole_grid ? static_cast<int>(want) : swt::resident_grid(kernel, 0, want);
  kernel<<<grid, swt::kThreads, 0, stream>>>(data, end, offsets, lengths, width, count, seeds, out);
}

template <int K, int kMin>
void one(int kind, bool spans, const uint8_t* d, int64_t end, const int64_t* o, const int32_t* l, int64_t width, int64_t count,
         const swt::Seeds& g, void* out, cudaStream_t s) {
  if (kind == 0) {
    run(spans ? swt::xxh64_kernel<K, true, kMin> : swt::xxh64_kernel<K, false, kMin>, d, end, o, l, width, count, g,
        static_cast<uint64_t*>(out), s);
  } else if (kind == 1) {
    run(spans ? swt::xxh32_kernel<K, false, true, kMin> : swt::xxh32_kernel<K, false, false, kMin>, d, end, o, l, width, count,
        g, out, s);
  } else {
    run(spans ? swt::xxh32_kernel<K, true, true, kMin> : swt::xxh32_kernel<K, true, false, kMin>, d, end, o, l, width, count, g,
        out, s);
  }
}

}  // namespace

// kind: 0 XXH64, 1 XXH32, 2 swh64 (one seed each), 3 swh64 under 8 seeds;
// blocks: the launch bounds' blocks an SM (kinds 0-2: 4, 5 or 6; kind 3: 1,
// 2 or 3); whole: a block a 256 tokens in place of the resident grid. Spans
// when offsets is not null, else rows of `width` (end = count * width).
extern "C" int spans_variant_run(int64_t kind, int64_t blocks, int64_t whole, const void* data, int64_t end,
                                 const void* offsets, const void* lengths, int64_t width, int64_t count, const void* seeds,
                                 void* out, void* stream) {
  whole_grid = whole != 0;
  const auto* d = static_cast<const uint8_t*>(data);
  const auto* o = static_cast<const int64_t*>(offsets);
  const auto* l = static_cast<const int32_t*>(lengths);
  const auto s = static_cast<cudaStream_t>(stream);
  const bool spans = o != nullptr;
  const swt::Seeds g = swt::seed_group(static_cast<const uint64_t*>(seeds), 0, kind == 3 ? 8 : 1);
  const int k = static_cast<int>(kind);
  switch (kind * 10 + blocks) {
#define SWT_ONE(B)                                                       \
  case B:                                                                \
  case 10 + B:                                                           \
  case 20 + B: one<1, B>(k, spans, d, end, o, l, width, count, g, out, s); break;
    SWT_ONE(4)
    SWT_ONE(5)
    SWT_ONE(6)
#undef SWT_ONE
    case 31: one<8, 1>(2, spans, d, end, o, l, width, count, g, out, s); break;
    case 32: one<8, 2>(2, spans, d, end, o, l, width, count, g, out, s); break;
    case 33: one<8, 3>(2, spans, d, end, o, l, width, count, g, out, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
