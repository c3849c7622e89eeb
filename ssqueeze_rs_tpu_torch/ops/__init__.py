from .stft import stft, istft, stft_core, overlap_add
from ..utils.windows import get_window
from .cwt import cwt, icwt, cwt_core, cwt_higher_order
from .phase import phase_cwt, phase_stft, phase_cwt_num
from .ssqueeze import (ssqueeze, reassign, compute_associated_frequencies,
                       ssq_freqrange)
from .ssq_cwt import ssq_cwt, issq_cwt
from .ssq_stft import ssq_stft, issq_stft, make_Sfs
from .tkeo import tkeo, tkeo_modified

__all__ = [
    "stft", "istft", "stft_core", "get_window", "overlap_add",
    "cwt", "icwt", "cwt_core", "cwt_higher_order",
    "phase_cwt", "phase_stft", "phase_cwt_num",
    "ssqueeze", "reassign", "compute_associated_frequencies", "ssq_freqrange",
    "ssq_cwt", "issq_cwt", "ssq_stft", "issq_stft", "make_Sfs",
    "tkeo", "tkeo_modified",
]
