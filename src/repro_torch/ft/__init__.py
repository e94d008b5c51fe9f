"""repro_torch.ft — fault tolerance: detection (heartbeat), planning
(elastic), deterministic fault injection (inject), and supervised
recovery (supervisor). The closed loop is exercised end to end by the
soak harness, ``python -m repro_torch.launch.soak`` (DESIGN.md §11).

Port of ``src/repro/ft``. Everything but ``inject.poison_loss_fn`` is host
logic (topologies, heartbeat files, fault plans drawn with numpy, the
supervisor's state machine) and keeps the reference's code; the port holds
its own copy so that it imports nothing of the reference.
"""
from repro_torch.ft.elastic import (Topology, plan_contraction, plan_expansion,
                              reassign_data_hosts)
from repro_torch.ft.heartbeat import (HeartbeatConfig, HeartbeatMonitor,
                                detect_stragglers)
from repro_torch.ft.inject import (FaultEvent, FaultPlan, corrupt_newest_checkpoint,
                             litter_tmp_dir, poison_loss_fn, random_storm,
                             scripted_storm)
from repro_torch.ft.supervisor import (RecoveryActions, RecoveryEvent, Supervisor,
                                 SupervisorConfig, SupervisorHalted)

__all__ = [
    "Topology", "plan_contraction", "plan_expansion", "reassign_data_hosts",
    "HeartbeatConfig", "HeartbeatMonitor", "detect_stragglers",
    "FaultEvent", "FaultPlan", "corrupt_newest_checkpoint",
    "litter_tmp_dir", "poison_loss_fn", "random_storm", "scripted_storm",
    "RecoveryActions", "RecoveryEvent", "Supervisor", "SupervisorConfig",
    "SupervisorHalted",
]
