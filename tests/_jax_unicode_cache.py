"""A private on-disk cache for the JAX package's Unicode tables.

The JAX package builds its Unicode tables at first use and writes each to
``~/.cache/swtpu-unicode`` with ``np.savez_compressed``, which is not atomic:
under the parallel test run another worker can read a file half written,
or write one while this worker reads it. A port test module that holds the
port to those tables imports ``private_jax_unicode_cache`` (an autouse
fixture of module scope), which points the JAX package's cache at a
directory of the module's own while it runs; tables already loaded in the
process stay loaded.
"""

import pytest


@pytest.fixture(scope="module", autouse=True)
def private_jax_unicode_cache(tmp_path_factory):
    from stringwars_tpu.unicode import tables

    mp = pytest.MonkeyPatch()
    mp.setattr(tables, "_CACHE_DIR", str(tmp_path_factory.mktemp("swtpu-unicode")))
    yield
    mp.undo()
