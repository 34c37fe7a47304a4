"""SLO autopilot for the port's gateway: alert-driven actuation with
bounded authority (a copy of the reference's ``kubeflow_tpu/autopilot``
as far as the gateway and the pod entrypoint use it).
``KFT_AUTOPILOT=0`` disables the layer; see
:mod:`kubeflow_tpu_torch.autopilot.core`."""

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
    "GatewayAdmissionActuator",
    "autopilot_enabled",
]
