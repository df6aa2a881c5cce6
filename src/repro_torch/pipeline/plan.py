"""Typed job plans: an n-gram method as data over the shared stages (port of
``repro.pipeline.plan``).

A :class:`JobPlan` is the declarative form of one of the paper's algorithms:
how the map phase emits records from a token window, whether a map-side
combiner runs, what the shuffle partitions by, and which reducer interprets
the sorted runs.  ``rounds`` and ``update_carry`` chain the multi-job methods
(APRIORI-SCAN/-INDEX): the carry is the state one job hands the next (the
frequent-gram dictionary, the posting-list occurrence mask).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

from repro_torch.core.stats import NGramConfig

# map emit: (tok_ext, aux_ext, n_live, cfg, carry, k) ->
#   (records [N, W] int64, valid [N] bool, emit_extras dict)
EmitFn = Callable[..., tuple]

# carry update: (cfg, tau_eff, k, tok_ext, stats_k, reduce_extras,
#                emit_extras, carry) -> new carry
CarryFn = Callable[..., Any]


@dataclass(frozen=True)
class MapStage:
    emit: EmitFn
    n_meta: int = 0          # meta lanes after the weight lane (positions, ...)


@dataclass(frozen=True)
class CombineStage:
    route: str = "sort"      # "sort" | "hash"


@dataclass(frozen=True)
class ShuffleStage:
    key: str = "gram"        # "gram" (whole-record hash) | "lead" (first term)


@dataclass(frozen=True)
class SortStage:
    pass                     # keys = the packed gram lanes (n_lanes of the plan)


@dataclass(frozen=True)
class ReduceStage:
    kind: str = "exact"      # "exact" (whole-gram) | "suffix" (every prefix)
    with_positions: bool = False


@dataclass(frozen=True)
class JobPlan:
    name: str
    map: MapStage
    shuffle: ShuffleStage
    sort: SortStage
    reduce: ReduceStage
    combine: CombineStage | None = None
    rounds: int = 1                       # jobs chained (sigma for APRIORI-*)
    stop_on_empty: bool = False           # terminate when a round emits nothing
    update_carry: CarryFn | None = None   # None: stateless rounds
    lane_vocab: int = 0                   # packer vocab (0: cfg.vocab_size)

    def effective_lane_vocab(self, cfg: NGramConfig) -> int:
        return self.lane_vocab or cfg.vocab_size


def plan_for(cfg: NGramConfig) -> JobPlan:
    """The registered :class:`JobPlan` of ``cfg.method``."""
    from repro_torch.core import PLANS
    try:
        build = PLANS[cfg.method]
    except KeyError:
        raise ValueError(
            f"no JobPlan registered for method {cfg.method!r}; "
            f"options: {sorted(PLANS)}") from None
    return build(cfg)
