"""ssqueeze_rs_tpu_torch: the PyTorch + CUDA port of ssqueeze_rs_tpu.

Same public names, signatures and return tuples as the JAX package for
what is ported so far: the synchrosqueezed CWT (`ssq_cwt`, `issq_cwt`) and
the STFT family (`stft`, `istft`, `ssq_stft`, `issq_stft`, `phase_stft`)
with their host planning. On a CUDA tensor the hand-written Hopper
kernels run (``csrc/*.cu``, built with nvcc at first use); on a CPU tensor
their plain-torch versions run. ROADMAP.md lists what is still to be
ported.
"""
from .ops import (ssq_cwt, issq_cwt, ssq_stft, issq_stft, ssqueeze, stft,
                  istft, phase_stft)
from .scales import process_scales
from .utils import get_window, mad_rms
from .wavelets import Wavelet, center_frequency, adm_ssq

__all__ = ["ssq_cwt", "issq_cwt", "ssq_stft", "issq_stft", "ssqueeze", "stft",
           "istft", "phase_stft", "get_window", "mad_rms", "process_scales",
           "Wavelet", "center_frequency", "adm_ssq"]
