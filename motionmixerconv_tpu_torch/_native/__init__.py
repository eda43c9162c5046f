"""Native (C++) host components, built with the system's ``g++`` at first
use.

Counterpart of ``motionmixerconv_tpu/_native``: the CSV reader that
``data/h36m.py`` reads every H3.6M and CMU corpus through. It builds into
``build/native/`` at the repository root; a failed build raises (the JAX
package's falls back to numpy). Host code only: the CUDA kernels are in
``csrc/``.
"""

from .build import load_csv_reader, read_csv_many_native, read_csv_native

__all__ = ["load_csv_reader", "read_csv_many_native", "read_csv_native"]
