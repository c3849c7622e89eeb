from .cwt import cwt, icwt
from .ssq_cwt import ssq_cwt, issq_cwt
from .ssq_stft import ssq_stft, issq_stft
from .ssqueeze import ssqueeze
from .stft import stft, istft
from .phase import phase_cwt, phase_cwt_num, phase_stft

__all__ = ["cwt", "icwt", "ssq_cwt", "issq_cwt", "ssq_stft", "issq_stft",
           "ssqueeze", "stft", "istft", "phase_cwt", "phase_cwt_num",
           "phase_stft"]
