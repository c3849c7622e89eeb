from .base import Wavelet
from . import families  # noqa: F401  (registers morlet/bump/cmhat/hhhat)
from . import gmw as _gmw_mod  # noqa: F401  (registers gmw)
from .gmw import morsefreq, gmw_k_constants
from .props import center_frequency, find_maximum, find_first_occurrence
from .adm import adm_ssq, integrate_analytic

__all__ = [
    "Wavelet", "morsefreq", "gmw_k_constants", "center_frequency",
    "find_maximum", "find_first_occurrence", "adm_ssq", "integrate_analytic",
]
