"""Model rollout & quality plane.

Closes the trainer→scheduler loop with evidence instead of operator
fiat: shadow scoring re-ranks a sampled slice of live announces with
the candidate model off the hot path (shadow.py), replay evaluation
joins those counterfactual rankings against realized Download outcomes
(evaluation.py), and a manager-side controller walks each candidate
through CANDIDATE→SHADOW→CANARY→ACTIVE behind guardrails, rolling back
to the last-good version on regression (controller.py).  The scheduler
side reports through client.py/reporter.py; canary serving itself lives
on the evaluator (scheduler/evaluator.py + scheduler/microbatch.py).
"""

from .client import CandidateInfo, LocalRolloutClient, RolloutRESTClient  # noqa: F401
from .controller import (  # noqa: F401
    Rollout,
    RolloutController,
    RolloutGuardrails,
    RolloutPhase,
)
from .evaluation import (  # noqa: F401
    evaluate_shadow,
    join_outcomes,
    load_replay_rows,
    pairwise_inversion_rate,
    population_stability_index,
    regret_at_k,
)
from .reporter import RolloutReporter  # noqa: F401
from .shadow import SHADOW_COLUMNS, ShadowScorer  # noqa: F401
