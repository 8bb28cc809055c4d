"""Model planes over more than one learner or process (counterpart of
``twtml_tpu/parallel``): the tenant plane (``tenants.py``, ``--tenants
M``), M stacked learners on one wire and one fetch a tick; the lockstep
multi-host runtime (``distributed.py``, ``sharding.py``, ``mesh.py``),
N processes training one model. The elastic and 2D parts of the JAX
package are ROADMAP A10b."""

from .tenants import TenantStackModel, aggregate_tenant_output, split_tenant_output

__all__ = ["TenantStackModel", "aggregate_tenant_output", "split_tenant_output"]
