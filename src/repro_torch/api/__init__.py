"""``repro_torch.api`` — execution plans and device selection."""
from repro_torch.api.plan import ExecutionPlan, resolve_device, resolve_plan
