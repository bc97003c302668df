"""The port's forward step against ``__graft_entry__.entry()``, and the
port's independence from JAX."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import __graft_entry__
from stringwars_tpu_torch import entry as E
from _torch_threads import one_thread  # noqa: F401


_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_entry_cpu_matches_graft_entry():
    ref_fn, ref_args = __graft_entry__.entry()
    want = ref_fn(*ref_args)
    fn, args = E.entry("cpu")
    for got_arg, ref_arg in zip(args, ref_args):
        assert got_arg.device == torch.device("cpu")
        np.testing.assert_array_equal(got_arg.numpy(), np.asarray(ref_arg))
    got = fn(*args)
    assert set(got) == set(want)
    assert got["digest_checksum"].dtype == torch.uint32
    assert int(got["digest_checksum"]) == int(want["digest_checksum"])
    np.testing.assert_array_equal(got["minhash"].numpy(), np.asarray(want["minhash"]))
    np.testing.assert_array_equal(got["translated"].numpy(), np.asarray(want["translated"]))


def test_entry_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        E.entry()


def test_entry_main_on_the_cpu(capsys):
    out = E.main(["--device", "cpu"])
    assert out["minhash"].shape == (64, 32) and out["translated"].shape == (64, 64)
    assert f"digest_checksum {int(out['digest_checksum'])}" in capsys.readouterr().out


def test_slice_imports_no_jax():
    code = (
        "import sys, stringwars_tpu_torch.suites.hash, stringwars_tpu_torch.suites.fingerprints, "
        "stringwars_tpu_torch.entry, stringwars_tpu_torch.ops.hash_cuda, stringwars_tpu_torch.ops.memops; "
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'stringwars_tpu' or m.startswith('stringwars_tpu.')]; "
        "print(bad); sys.exit(1 if bad else 0)"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=_REPO, capture_output=True, text=True)
    assert out.returncode == 0, out.stdout + out.stderr
