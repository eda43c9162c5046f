"""Build the JAX package's native CSV reader once, before any test worker
starts.

``tests/test_native_csv.py`` decides at collection whether the reader
builds (``needs_native``), in every xdist worker at once. On a cold cache
the workers' compiles race for one temporary file, and a worker that loses
skips those tests as if there were no C++ compiler. Building here, in the
controlling process alone, leaves the library in the cache under the name
the workers look for, so none of them compiles.

``motionmixerconv_tpu/_native/build.py`` imports only the standard library
and numpy, so it is loaded by file path: neither ``jax`` nor the package's
``__init__`` is imported. Where there is no compiler it returns None and
the tests skip as before.
"""

import importlib.util
import os

_BUILD = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "motionmixerconv_tpu", "_native", "build.py")


def pytest_configure(config):
    if hasattr(config, "workerinput"):  # an xdist worker
        return
    spec = importlib.util.spec_from_file_location("_mmc_native_build", _BUILD)
    build = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(build)
    build.load_csv_reader()
