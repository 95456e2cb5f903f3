"""Batched multi-source query engine.

Turns many single-source questions into a few wide bit-matrix launches:
frontier matrices, the query loops and GNN inference (``queries``),
launch-plan caching (``planner``), request coalescing (``batcher``), and
the fault-tolerant serving front end (``server``: deadlines, backend
fallback, circuit breakers, restart-safe warmup) with deterministic
fault injection (``faults``).
"""

from repro_torch.engine.batcher import (KINDS, BatchFlushError,  # noqa: F401
                                        QueryBatcher, QueryGroupError,
                                        QueryHandle, launch_group,
                                        validate_query)
from repro_torch.engine.faults import FaultInjector, InjectedFault  # noqa: F401
from repro_torch.engine.planner import (DEFAULT_PLANNER, Plan,  # noqa: F401
                                        PlanCache, PlanKey, descriptor_key,
                                        plan_key)
from repro_torch.engine.queries import (BatchedPPRResult,  # noqa: F401
                                        GNNInferResult, GNNModel,
                                        MSBFSResult, MSSSSPResult,
                                        batched_ppr, gnn_infer, ms_sssp,
                                        msbfs, mskhop, register_gnn_model)
from repro_torch.engine.server import (CircuitBreaker,  # noqa: F401
                                       GraphQueryServer, QueryRejected,
                                       ServerConfig, ServerStats)
