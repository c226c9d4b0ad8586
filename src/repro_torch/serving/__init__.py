"""Serving: paged KV cache + continuous-batching engine + samplers.

    from repro_torch.serving import ServeEngine, Request, SamplingParams

    eng = ServeEngine(cfg, params, max_batch=8, max_len=512)  # on the card
    for out in eng.stream(Request(prompt=ids,
                                  sampling=SamplingParams(max_new=64))):
        print(out.rid, out.token, out.finished)
"""

from repro_torch.serving.engine import Admission, ServeEngine
from repro_torch.serving.faults import (NO_FAULTS, FaultPlan, FaultSpec,
                                        InjectedFault, parse_faults)
from repro_torch.serving.kv_cache import (PagedKVCache, PrefixMatch,
                                          TRASH_PAGE, pages_for)
from repro_torch.serving.request import (Request, RequestOutput,
                                         RequestState, SamplingParams)
from repro_torch.serving.scheduler import (QueueFullError, RejectionError,
                                           Scheduler, TickPlan)

__all__ = [
    "Admission", "ServeEngine", "Scheduler", "TickPlan", "PagedKVCache",
    "PrefixMatch", "TRASH_PAGE", "pages_for", "Request", "RequestOutput",
    "RequestState", "SamplingParams", "FaultPlan", "FaultSpec",
    "InjectedFault", "NO_FAULTS", "parse_faults", "RejectionError",
    "QueueFullError",
]
