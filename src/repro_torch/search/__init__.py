"""Search-augmented placement: refine any seed proposal through the
batched oracle under an anytime budget.

Public surface:

* ``SearchPlacer``  -- a ``Placer`` that composes a seed placer with a
  search strategy (also re-exported from ``repro_torch.api``);
* ``SearchConfig``  -- strategy selection + budget + per-family knobs;
* ``SearchScorer``  -- the budget-metered batched scoring seam, for
  building new strategies on top of.
"""

from repro_torch.search.placer import STRATEGIES, SearchConfig, SearchPlacer
from repro_torch.search.scoring import SearchScorer

__all__ = ["STRATEGIES", "SearchConfig", "SearchPlacer", "SearchScorer"]
