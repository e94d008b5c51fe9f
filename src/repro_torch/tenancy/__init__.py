"""Multi-tenant LoRA fine-tuning (DESIGN.md §14).

Port of ``src/repro/tenancy``. Thousands of users each own a low-rank
adapter; one fused pass per step computes per-example gradient norms,
per-example clipping, and per-tenant DP noise across every tenant in the
batch — tenants are segments, exactly like MoE experts.
"""
from repro_torch.tenancy.adapters import AdapterStore
from repro_torch.tenancy.batch import (TenantBatch, assemble,
                                       per_tenant_count, per_tenant_max,
                                       per_tenant_mean, per_tenant_min,
                                       per_tenant_sum)
from repro_torch.tenancy.service import TenantService, TenantStepResult

__all__ = [
    "AdapterStore", "TenantBatch", "assemble", "TenantService",
    "TenantStepResult", "per_tenant_count", "per_tenant_max",
    "per_tenant_mean", "per_tenant_min", "per_tenant_sum",
]
