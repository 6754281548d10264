"""Fleet-scale event-driven serving simulation (docs/SIMULATOR.md): the
port's copy of the JAX package's ``sim/``.

``repro_torch.sim`` drives N single-replica Bullet state machines
(:class:`repro_torch.core.simulate.BulletReplicaSim`, each one H100 on the
port's ``HardwareSpec``) behind a cluster router in one event heap — the
capacity-planning level of the simulator stack. The single-replica level
lives in ``repro_torch.core.simulate``; ``replay_vs_sim`` holds it against
the port's own ``BulletServer``.
"""

from repro_torch.sim.capacity import (attainment_curve, capacity_search,
                                      slo_holds, tail_point)
from repro_torch.sim.cluster import (ClusterConfig, ClusterResult,
                                     ClusterSimulator, ROUTERS, make_router)
__all__ = [
    "ClusterConfig", "ClusterResult", "ClusterSimulator", "ROUTERS",
    "make_router", "attainment_curve", "capacity_search", "slo_holds",
    "tail_point",
]
