"""repro_torch.runtime -- the resource-centric public API of the port.

One surface for train, serve and simulate::

    from repro_torch.runtime import Application, Cluster, TorchExecutor

    cluster = Cluster(pods=1, history=history, executor=TorchExecutor())
    handle = cluster.submit(Application.train("tinyllama-1.1b",
                                              reduced=True))
    handle.run(steps=20)
    handle.release()

The counterpart of ``repro/runtime``.  The autoscale control plane
lives in ``repro_torch.autoscale`` (imported lazily by
``Cluster.enable_autoscale`` and ``AppHandle.park``).
"""

from repro_torch.runtime.application import REDUCED_SHAPES, Application
from repro_torch.runtime.cluster import AppHandle, Cluster
from repro_torch.runtime.executors import (Executor, NullExecutor,
                                           TorchExecutor)
from repro_torch.runtime.options import ScalePolicy, ServeOptions
from repro_torch.runtime.simulate import (measure_cluster_throughput,
                                          replay_trace)

__all__ = [
    "Application", "AppHandle", "Cluster",
    "Executor", "NullExecutor", "TorchExecutor",
    "REDUCED_SHAPES", "ScalePolicy", "ServeOptions",
    "measure_cluster_throughput", "replay_trace",
]
