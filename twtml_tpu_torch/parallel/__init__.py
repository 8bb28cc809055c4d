"""Model planes over more than one learner or process (counterpart of
``twtml_tpu/parallel``): the tenant plane (``tenants.py``, ``--tenants
M``), M stacked learners on one wire and one fetch a tick; the lockstep
multi-host runtime (``distributed.py``, ``sharding.py``, ``mesh.py``),
N processes training one model; its elastic membership (``elastic.py``,
``service_host.py``, ``--elastic on``); and the layouts over a model axis
(``mesh.py``'s ``ModelMesh``): the 2D feature-sharded step
(``sharding.py``), the tenant stack over a mesh and the tenant fleet
across hosts (``tenants.py``), and k-means across hosts
(``models/kmeans.py``).

The tenant plane's names import on first use, so a process that needs only
a submodule (the elastic store's ``service_host``) does not load the
models."""

__all__ = ["TenantStackModel", "aggregate_tenant_output", "split_tenant_output"]


def __getattr__(name):
    if name in __all__:
        from . import tenants

        return getattr(tenants, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
