"""Core paper technique: Swift (workflow DSL + XDTM) / Karajan (futures
engine) / Falkon (multi-level scheduling), the PyTorch port's copy.

The counterpart of the JAX package's `repro/core/`: the same layered
scheduler subsystem (see DESIGN.md): task records
(`repro_torch.core.task`) -> providers (`repro_torch.core.providers`) ->
Falkon service (`repro_torch.core.falkon`) -> sites/load balancing
(`repro_torch.core.sites`) -> engine dataflow + dispatch policy
(`repro_torch.core.engine`), with the device tier
(`repro_torch.core.clustering`, `repro_torch.core.devicepool`) on
`torch.func.vmap`, and the reliability half: the durable job store
(`repro_torch.core.jobstore`), the workflow service over it
(`repro_torch.core.service`), and the in-process and process-per-shard
federations (`repro_torch.core.federation`, `repro_torch.core.procfed`).

Public API:
    Engine, Workflow, Dataset, mappers, FalkonService, providers,
    RestartLog, FaultInjector, SimClock/RealClock, DeviceExecutorPool,
    JobStore, WorkflowService, FederatedEngine, ProcessFederation.
"""
from repro_torch.core.clustering import VmapClusteringProvider
from repro_torch.core.datastore import (DataLayer, DataObject,
                                        EvictionPolicy, ExecutorCache,
                                        LFUPolicy, LRUPolicy,
                                        ShardDirectory, SharedStore,
                                        SizeAwarePolicy, StagingCostModel)
from repro_torch.core.devicepool import DeviceExecutorPool
from repro_torch.core.engine import Engine
from repro_torch.core.falkon import DRPConfig, FalkonConfig, FalkonService
from repro_torch.core.faults import FaultInjector, RetryPolicy, TaskFailure
from repro_torch.core.federation import (FederatedEngine, Mailbox,
                                         MailboxTransport, QueueTransport,
                                         ShardedDataLayer, WorkStealer,
                                         hash_partitioner,
                                         inputs_partitioner,
                                         skewed_partitioner)
from repro_torch.core.futures import (CompletionCounter, DataFuture,
                                      resolved, when_all)
from repro_torch.core.health import (METRICS_STREAM_SCHEMA, HealthConfig,
                                     HealthMonitor, RollingStat)
from repro_torch.core.jobstore import (IllegalTransition, JobStore, Journal,
                                       TaskStateMachine, WorkflowState)
from repro_torch.core.metrics import StreamStat
from repro_torch.core.observability import (BoundedLog, MetricsRegistry,
                                            RunReport, Span, Tracer,
                                            build_report)
from repro_torch.core.procfed import (ProcessFederation, ProcessTransport,
                                      Ref, ShardHost, ShardSpec,
                                      SocketTransport)
from repro_torch.core.provenance import VDC, InvocationRecord
from repro_torch.core.providers import (BatchSchedulerProvider,
                                        ClusteringProvider, FalkonProvider,
                                        LocalProvider, Provider,
                                        WorkerPoolProvider)
from repro_torch.core.realpool import ProcessExecutorPool, ThreadExecutorPool
from repro_torch.core.restart_log import RestartLog
from repro_torch.core.service import (ResumeView, WorkflowHandle,
                                      WorkflowService)
from repro_torch.core.simclock import RealClock, SimClock
from repro_torch.core.sites import LoadBalancer, Site
from repro_torch.core.task import Task, task_key
from repro_torch.core.workflow import Procedure, Workflow
from repro_torch.core.xdtm import (ArrayOf, CSVMapper, Dataset, FILE,
                                   FileSystemMapper, FLOAT, INT, ListMapper,
                                   Mapper, PhysicalRef, Primitive,
                                   ShardMapper, STRING, Struct)

__all__ = [
    "Engine", "Workflow", "Procedure", "Task", "task_key",
    "Provider", "WorkerPoolProvider",
    "LocalProvider", "BatchSchedulerProvider", "FalkonProvider",
    "ClusteringProvider", "VmapClusteringProvider",
    "FalkonService", "FalkonConfig", "DRPConfig",
    "ThreadExecutorPool", "ProcessExecutorPool", "DeviceExecutorPool",
    "DataFuture", "CompletionCounter", "resolved", "when_all",
    "SimClock", "RealClock",
    "RestartLog", "FaultInjector", "RetryPolicy", "TaskFailure",
    "JobStore", "Journal", "TaskStateMachine", "IllegalTransition",
    "WorkflowState", "WorkflowService", "WorkflowHandle", "ResumeView",
    "VDC", "InvocationRecord", "LoadBalancer", "Site", "StreamStat",
    "Tracer", "Span", "BoundedLog", "MetricsRegistry", "RunReport",
    "build_report",
    "HealthMonitor", "HealthConfig", "RollingStat",
    "DataLayer", "DataObject", "SharedStore", "ExecutorCache",
    "StagingCostModel", "EvictionPolicy", "LRUPolicy", "LFUPolicy",
    "SizeAwarePolicy", "ShardDirectory",
    "FederatedEngine", "Mailbox", "MailboxTransport", "QueueTransport",
    "WorkStealer", "ShardedDataLayer",
    "ProcessFederation", "ShardSpec", "ShardHost", "ProcessTransport",
    "SocketTransport", "Ref",
    "hash_partitioner", "skewed_partitioner", "inputs_partitioner",
    "Dataset", "Mapper", "ListMapper", "FileSystemMapper", "CSVMapper",
    "ShardMapper", "PhysicalRef", "Struct", "ArrayOf", "Primitive",
    "INT", "FLOAT", "STRING", "FILE",
]
