from .base import Wavelet, isinstance_by_name
from . import families  # noqa: F401  (registers morlet/bump/cmhat/hhhat)
from .families import morlet, bump, cmhat, hhhat
from . import gmw as _gmw_mod  # noqa: F401  (registers gmw)
from .gmw import (morsefreq, morsewave, morseafun, laguerre,
                  gmw_k_constants, gmw, gmw_l1, gmw_l2, gmw_l1_k,
                  gmw_l2_k, compute_gmw)
from .props import (center_frequency, freq_resolution, time_resolution,
                    find_maximum, find_first_occurrence)
from .adm import adm_cwt, adm_ssq, integrate_analytic

__all__ = [
    "Wavelet", "isinstance_by_name", "morlet", "bump", "cmhat", "hhhat",
    "gmw", "gmw_l1", "gmw_l2", "gmw_l1_k", "gmw_l2_k", "compute_gmw",
    "morsefreq", "morsewave", "morseafun", "laguerre",
    "gmw_k_constants", "center_frequency", "freq_resolution",
    "time_resolution", "find_maximum", "find_first_occurrence",
    "adm_cwt", "adm_ssq", "integrate_analytic",
]
