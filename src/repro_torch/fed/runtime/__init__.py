"""Event-driven federation runtime (torch port of ``repro/fed/runtime``).

* :mod:`sampling`  — client registry and per-round cohort sampling with
  Horvitz–Thompson weights (a numpy copy of the reference),
* :mod:`transport` — the wire: scalar / dense / quantized upload frames,
  the lossy channel, and the dense or digest downlink (numpy),
* :mod:`server`    — the streaming aggregator with deadline and
  staleness handling (a numpy copy),
* :mod:`engine`    — the round driver: local SGD on the device, the
  protocol's encode and apply through the port's CUDA kernels,
* :mod:`scheduler` — the continuous-round driver on top of the engine:
  admission control, quorum-xor-deadline closure, pipelined (async)
  rounds over a modeled float64 timeline.
"""
from repro_torch.fed.runtime.engine import (
    EngineCore,
    RuntimeConfig,
    StatefulClient,
    draw_cohort_batches,
    run_federation,
)
from repro_torch.fed.runtime.sampling import (
    ClientPopulation,
    Cohort,
    CohortSampler,
    realized_cohort_weights,
    sampling_diagnostic,
)
from repro_torch.fed.runtime.scheduler import (
    AdmissionController,
    CohortBatch,
    SchedulerConfig,
    quorum_close_time,
    run_scheduled,
)
from repro_torch.fed.runtime.server import (
    RoundStats,
    ServerConfig,
    StreamingAggregator,
    Upload,
)
from repro_torch.fed.runtime.transport import (
    DenseFrameCodec,
    DigestCodec,
    DownlinkChannel,
    QuantizedFrameCodec,
    RoundDigest,
    RoundLog,
    UplinkChannel,
    WireFormat,
    decode_upload,
    encode_upload,
)

__all__ = [
    "RuntimeConfig", "run_federation", "draw_cohort_batches",
    "StatefulClient", "EngineCore",
    "SchedulerConfig", "run_scheduled", "AdmissionController",
    "CohortBatch", "quorum_close_time",
    "ClientPopulation", "Cohort", "CohortSampler",
    "realized_cohort_weights", "sampling_diagnostic",
    "ServerConfig", "StreamingAggregator", "Upload", "RoundStats",
    "WireFormat", "DenseFrameCodec", "QuantizedFrameCodec",
    "UplinkChannel", "DownlinkChannel", "DigestCodec", "RoundDigest",
    "RoundLog",
    "encode_upload", "decode_upload",
]
