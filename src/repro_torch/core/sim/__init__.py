"""The NANOS task-runtime simulator, the paper's own half (own copy of
``repro/core/sim``): BOTS task trees compiled into flat tables, the
stock and NUMA-aware schedulers as declarative policies, the paper's
thread bindings and data placements, fault models, and figure grids
through the :class:`Machine` facade.

On a CUDA device every grid runs in the hand-written kernel
``kernels/csrc/sim.cu``, one thread per cell (its traced instantiation
under ``SimParams(trace=True)``); on ``device="cpu"`` the plain version
(``_engine_py``) runs on the host. Both match the JAX package's C engine
bit for bit, traces included. Sweeps journal to a :class:`ResultStore`,
give cells wall-clock deadlines, and reuse compile products across
processes through the :mod:`.compile_cache`.
"""

from .runtime import (TaskSpec, Workload, SimParams, SimResult, SimStalled,
                      simulate, run_context, run_cells, serial_time,
                      resolve_timeout, SCHEDULERS, SchedulerSpec, TaskTable,
                      ensure_table)
from .policy import register, get_spec, compile_victim_plan
from .context import (BindingSpec, PlacementSpec, ExecContext, BINDINGS,
                      PLACEMENTS, register_binding, register_placement,
                      get_binding, get_placement)
from .faults import (FaultSpec, FaultPlan, FAULTS, register_fault,
                     get_fault, get_faults, compile_fault_plan)
from .machine import Machine, Grid, GridKey
from .sweep import (SweepConfig, SweepPlan, CellError, CellTimeout,
                    RetryPolicy, run_sweep, Stat, CellStats, aggregate)
from .store import ResultStore, cell_key, workload_fingerprint
from .trace import TraceBuffer
from .compile_cache import (CompileCache, get_cache, reset_cache,
                            cache_root)
from . import (bots, compile_cache, context, faults, machine, policy,
               store, sweep, trace)
