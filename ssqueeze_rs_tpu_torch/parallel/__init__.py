"""Long signals (counterpart of ``ssqueeze_rs_tpu/parallel``): the
out-of-core recording pipeline and the host planning of halo chunks. The
device mesh, the sharded `chunked_*` transforms and multi-host set-up
wait for ROADMAP Queue 1 item 8."""
from .chunked import default_cwt_halo, overlap_save_tail_mass
from .pipeline import (process_recording, process_stft, process_cwt,
                       process_ssq_cwt, process_ssq_stft)

__all__ = ["default_cwt_halo", "overlap_save_tail_mass",
           "process_recording", "process_stft", "process_cwt",
           "process_ssq_cwt", "process_ssq_stft"]
