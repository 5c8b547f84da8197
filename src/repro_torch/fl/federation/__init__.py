"""Pluggable federation policies for the cross-region merge.

See ``repro_torch.fl.federation.base`` for the API surface
(:class:`FederationConfig`, :class:`FederationState`, :class:`MergePlan`,
:class:`MergePolicy`, the registry) and
``repro_torch.fl.federation.policies`` for the built-ins (``synchronous``,
``soft_async``, ``partial``, ``elected_hub``).
"""
from .base import (ELECTION_CRITERIA, FederationConfig, FederationState,
                   MergePlan, MergePolicy, POLICIES, RegionFedState,
                   get_policy, list_policies, register_policy,
                   resolve_federation)
from .policies import (ElectedHubPolicy, PartialPolicy, SoftAsyncPolicy,
                       SynchronousPolicy, plan_under_partition)

__all__ = ["ELECTION_CRITERIA", "FederationConfig", "FederationState",
           "MergePlan", "MergePolicy", "POLICIES", "RegionFedState",
           "get_policy", "list_policies", "register_policy",
           "resolve_federation", "ElectedHubPolicy", "PartialPolicy",
           "SoftAsyncPolicy", "SynchronousPolicy", "plan_under_partition"]
