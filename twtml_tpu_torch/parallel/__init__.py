"""Model planes over more than one learner (counterpart of
``twtml_tpu/parallel``): the tenant plane (``tenants.py``, ``--tenants
M``), M stacked learners on one wire and one fetch a tick. The data
parallel, multi-host and elastic parts of the JAX package are ROADMAP
A10."""

from .tenants import TenantStackModel, aggregate_tenant_output, split_tenant_output

__all__ = ["TenantStackModel", "aggregate_tenant_output", "split_tenant_output"]
