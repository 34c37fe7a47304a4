"""SLO autopilot for the port's gateway and train loop: alert-driven
actuation with bounded authority (a copy of the reference's
``kubeflow_tpu/autopilot`` as far as the gateway, the pod entrypoint and
``run_with_checkpointing``'s cadence signal use it).
``KFT_AUTOPILOT=0`` disables the layer; see
:mod:`kubeflow_tpu_torch.autopilot.core`."""

from kubeflow_tpu_torch.autopilot.checkpoint import CheckpointCadenceActuator
from kubeflow_tpu_torch.autopilot.core import (
    ActuationGuard,
    Actuator,
    Autopilot,
    AutopilotCollector,
    autopilot_enabled,
)
from kubeflow_tpu_torch.autopilot.serving import GatewayAdmissionActuator

__all__ = [
    "ActuationGuard",
    "Actuator",
    "Autopilot",
    "AutopilotCollector",
    "CheckpointCadenceActuator",
    "GatewayAdmissionActuator",
    "autopilot_enabled",
]
