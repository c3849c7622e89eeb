"""ssqueeze_rs_tpu_torch: the PyTorch + CUDA port of ssqueeze_rs_tpu.

Same public names, signatures and return tuples as the JAX package for
what is ported so far: the CWT family (`cwt`, `icwt`, `phase_cwt`,
`phase_cwt_num`), the synchrosqueezed CWT (`ssq_cwt`, `issq_cwt`), the
STFT family (`stft`, `istft`, `ssq_stft`, `issq_stft`, `phase_stft`) with
their host planning, the streaming transforms (`StreamingSTFT`,
`StreamingSSQSTFT`, `StreamingCWT`, `StreamingSSQCWT`), the bucketed
`TransformServer` and the recording pipeline
(`parallel.process_recording`). Array input runs on the CUDA device unless
`device="cpu"` is given; a tensor runs on its own device. On a CUDA
tensor the hand-written Hopper kernels run (``csrc/*.cu``, built with nvcc
at first use); on a CPU tensor their plain-torch versions run. ROADMAP.md
lists what is still to be ported.
"""
from .config import DEFAULTS, EPS32, EPS64
from .ops import (cwt, icwt, ssq_cwt, issq_cwt, ssq_stft, issq_stft,
                  ssqueeze, stft, istft, phase_cwt, phase_cwt_num, phase_stft)
from .ops.cwt import cwt_higher_order
from .ops.diff import trigdiff
from .scales import (process_scales, make_scales, cwt_scalebounds,
                     infer_scaletype, logscale_transition_idx)
from .utils import (get_window, mad_rms, mad, WARN, NOTE, p2up, padsignal,
                    window_norm, xifn)
from .utils.fft import aifftshift_idx
from .wavelets import (Wavelet, center_frequency, time_resolution, adm_ssq,
                       adm_cwt, morsefreq, morseafun, gmw_k_constants,
                       find_maximum, find_first_occurrence)
from .serve import TransformServer
from .streaming import (StreamingSTFT, StreamingSSQSTFT, StreamingCWT,
                        StreamingSSQCWT)
from . import parallel

__all__ = ["cwt", "icwt", "ssq_cwt", "issq_cwt", "ssq_stft", "issq_stft",
           "ssqueeze", "stft", "istft", "phase_cwt", "phase_cwt_num",
           "phase_stft", "get_window", "mad_rms", "process_scales", "Wavelet",
           "center_frequency", "time_resolution", "adm_ssq", "adm_cwt",
           "cwt_higher_order", "trigdiff", "TransformServer",
           "StreamingSTFT", "StreamingSSQSTFT", "StreamingCWT",
           "StreamingSSQCWT", "parallel", "DEFAULTS", "EPS32", "EPS64", "mad",
           "WARN", "NOTE", "p2up", "padsignal", "window_norm", "xifn",
           "aifftshift_idx", "make_scales", "cwt_scalebounds",
           "infer_scaletype", "logscale_transition_idx", "find_maximum",
           "find_first_occurrence", "morsefreq", "morseafun",
           "gmw_k_constants"]
