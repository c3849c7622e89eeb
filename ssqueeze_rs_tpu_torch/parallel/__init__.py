"""Multi-card / multi-process parallelism (counterpart of
``ssqueeze_rs_tpu/parallel``): the device mesh, the time-sharded
`chunked_*` transforms with halo exchange, the multi-process runtime glue
and the out-of-core recording pipeline."""
from .mesh import make_mesh, shard_batch
from .chunked import (chunked_stft, chunked_cwt, chunked_ssq_cwt,
                      chunked_ssq_stft, chunked_istft, chunked_icwt,
                      chunked_issq_cwt, chunked_issq_stft,
                      default_cwt_halo, overlap_save_tail_mass,
                      comm_report)
from .distributed import (initialize, make_host_chip_mesh,
                          global_from_local, is_distributed)
from .pipeline import (process_recording, process_stft, process_cwt,
                       process_ssq_cwt, process_ssq_stft)

__all__ = ["make_mesh", "shard_batch", "chunked_stft", "chunked_cwt",
           "chunked_ssq_cwt", "chunked_ssq_stft", "chunked_istft",
           "chunked_icwt", "chunked_issq_cwt", "chunked_issq_stft",
           "default_cwt_halo",
           "overlap_save_tail_mass", "comm_report", "initialize",
           "make_host_chip_mesh",
           "global_from_local", "is_distributed", "process_recording",
           "process_stft", "process_cwt", "process_ssq_cwt",
           "process_ssq_stft"]
