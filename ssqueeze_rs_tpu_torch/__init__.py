"""ssqueeze_rs_tpu_torch: the PyTorch + CUDA port of ssqueeze_rs_tpu.

Same public names, signatures and return tuples as the JAX package for
what is ported so far: the synchrosqueezed CWT (`ssq_cwt`, `issq_cwt`)
with its host planning. On a CUDA tensor the two hand-written Hopper
kernels run (``csrc/cwt_phase.cu``, ``csrc/reassign.cu``, built with nvcc
at first use); on a CPU tensor their plain-torch versions run. ROADMAP.md
lists what is still to be ported.
"""
from .ops import ssq_cwt, issq_cwt, ssqueeze
from .scales import process_scales
from .wavelets import Wavelet, center_frequency, adm_ssq

__all__ = ["ssq_cwt", "issq_cwt", "ssqueeze", "process_scales", "Wavelet",
           "center_frequency", "adm_ssq"]
