from .common import (WARN, NOTE, assert_is_one_of, mad, mad_rms,
                     est_riskshrink_thresh, replace_at_inf_or_nan,
                     replace_at_inf, replace_at_nan, replace_at_value,
                     replace_under_abs)
from .fft import (xifn, aifftshift_idx, afftshift_idx, afftshift,
                  aifftshift, FFT, FFT_GLOBAL)
from .pad import (next_power_of_2, p2up, pad_params, padsignal, unpad,
                  PAD_MODES)
from .windows import (get_window, window_norm, window_resolution, window_area,
                      check_nola, buffer, unbuffer)

__all__ = [
    "WARN", "NOTE", "assert_is_one_of", "mad", "mad_rms",
    "est_riskshrink_thresh", "xifn", "aifftshift_idx", "afftshift_idx",
    "afftshift", "aifftshift", "FFT", "FFT_GLOBAL",
    "next_power_of_2", "p2up", "pad_params", "padsignal", "unpad", "PAD_MODES",
    "get_window", "window_norm", "window_resolution", "window_area",
    "check_nola", "buffer", "unbuffer",
]
