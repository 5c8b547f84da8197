"""Federated training on PyTorch: round loop, cohort execution,
aggregation, federation policies, baseline schemes.

Re-exports resolve lazily (PEP 562), as in the reference: importing
``repro_torch.fl.federation`` (the scenarios need its dataclasses) or
running ``python -m repro_torch.fl.baselines`` does not import the
training modules first.
"""
import importlib

# symbol -> defining submodule (relative)
_EXPORTS = {name: ".aggregation" for name in (
    "aggregation_weights", "client_finite_mask", "fedavg", "fedavg_pytrees",
    "fedavg_stacked", "fedavg_stacked_multi", "staleness_merge_weights",
    "staleness_weighted_merge", "tree_all_finite")}
_EXPORTS.update({name: ".baselines" for name in (
    "ALL_SCHEMES", "BASELINES", "SCHEME_HOOKS", "compare_schemes",
    "run_scheme")})
_EXPORTS.update({name: ".client" for name in (
    "cohort_local_update", "cross_entropy", "evaluate", "local_update",
    "masked_cross_entropy", "masked_local_update", "stacked_evaluate",
    "vmapped_local_update")})
_EXPORTS.update({name: ".cohort_engine" for name in (
    "CohortEngine", "CohortEngineStats")})
_EXPORTS.update({name: ".federation" for name in (
    "FederationConfig", "FederationState", "MergePlan", "MergePolicy",
    "RegionFedState", "get_policy", "list_policies", "register_policy",
    "resolve_federation")})
_EXPORTS.update({name: ".rounds" for name in (
    "FLConfig", "FLResult", "RegionTrainer", "run_fl")})

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    try:
        submodule = _EXPORTS[name]
    except KeyError:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}") from None
    value = getattr(importlib.import_module(submodule, __name__), name)
    globals()[name] = value  # cache: subsequent lookups skip __getattr__
    return value


def __dir__():
    return sorted(set(globals()) | set(__all__))
