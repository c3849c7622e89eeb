"""ssqueeze_rs_tpu_torch: the PyTorch + CUDA port of ssqueeze_rs_tpu.

Same public names, signatures and return tuples as the JAX package for
what is ported so far: the CWT family (`cwt`, `icwt`, `phase_cwt`,
`phase_cwt_num`), the synchrosqueezed CWT (`ssq_cwt`, `issq_cwt`), the
STFT family (`stft`, `istft`, `ssq_stft`, `issq_stft`, `phase_stft`) with
their host planning, the streaming transforms (`StreamingSTFT`,
`StreamingSSQSTFT`, `StreamingCWT`, `StreamingSSQCWT`), the bucketed
`TransformServer`, the recording pipeline
(`parallel.process_recording`), the wavelet builders (`morlet`, `gmw`,
`morsewave`, ...), ridge extraction (`extract_ridges`), the TKEO, the
test signals, `toolkit`, `experimental`, the reference's kernel-layer
names (`algos`), the drop-in `_rs` API (`compat`), the native host
runtime (`native`: the memory-mapped reader and its prefetch ring),
parquet recordings (`io`), plots (`visuals`, matplotlib imported at the
first plot) and the console entry point (`cli`). Every transform
takes `dtype="float64"` as the JAX package's does. Array input runs on the CUDA device unless
`device="cpu"` is given; a tensor runs on its own device. On a CUDA
tensor the hand-written Hopper kernels run (``csrc/*.cu``, built with nvcc
at first use); on a CPU tensor their plain-torch versions run.
"""
from .config import DEFAULTS, EPS32, EPS64, pi

__version__ = "0.1.0"

from .ops import (cwt, icwt, ssq_cwt, issq_cwt, ssq_stft, issq_stft,
                  ssqueeze, stft, istft, phase_cwt, phase_cwt_num, phase_stft)
from .ops.cwt import cwt_higher_order
from .ops.diff import trigdiff
from .scales import (process_scales, make_scales, cwt_scalebounds,
                     infer_scaletype, logscale_transition_idx)
from .ops.tkeo import tkeo, tkeo_modified
from .utils import (get_window, mad_rms, mad, WARN, NOTE, p2up, padsignal,
                    window_norm, window_resolution, xifn,
                    est_riskshrink_thresh, replace_at_inf_or_nan,
                    replace_at_inf, replace_at_nan, replace_at_value,
                    replace_under_abs)
from .utils.fft import aifftshift_idx, afftshift_idx
from .wavelets import (Wavelet, center_frequency, freq_resolution,
                       time_resolution, adm_ssq, adm_cwt, morsefreq,
                       morseafun, gmw_k_constants, find_maximum,
                       find_first_occurrence, morsewave, laguerre, morlet,
                       bump, cmhat, hhhat, gmw, gmw_l1, gmw_l2, gmw_l1_k,
                       gmw_l2_k, compute_gmw)
from .ridge import extract_ridges
from .signals import TestSignals
from .experimental import scale_to_freq, freq_to_scale
from .serve import TransformServer
from .streaming import (StreamingSTFT, StreamingSSQSTFT, StreamingCWT,
                        StreamingSSQCWT)
from .io import ParquetRecording, parquet_to_raw
from . import (algos, compat, experimental, io, parallel, ridge, signals,
               toolkit, visuals)


def wavs():
    """Names of the supported wavelet families."""
    from .wavelets.base import _FAMILIES
    return list(_FAMILIES)

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
           "gmw_k_constants", "pi", "wavs", "morlet", "bump", "cmhat",
           "hhhat", "gmw", "gmw_l1", "gmw_l2", "gmw_l1_k", "gmw_l2_k",
           "compute_gmw", "morsewave", "laguerre", "freq_resolution",
           "est_riskshrink_thresh", "replace_at_inf", "replace_at_nan",
           "replace_at_inf_or_nan", "replace_at_value", "replace_under_abs",
           "afftshift_idx", "window_resolution", "tkeo", "tkeo_modified",
           "extract_ridges", "ridge", "TestSignals", "signals", "toolkit",
           "experimental", "scale_to_freq", "freq_to_scale", "algos",
           "compat", "io", "ParquetRecording", "parquet_to_raw", "visuals"]
