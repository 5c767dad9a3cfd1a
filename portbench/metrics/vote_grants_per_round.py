"""Vote grants a round: the pre-vote and vote responses with reject 0
the route took from the outboxes over a ``--trace 1`` window (the
program's election census), over the window's rounds: the elections the
churn forces, at about a quorum of grants each."""
from portbench.metrics._census import per_round


def read(ctx):
    return per_round(ctx, ("prevote_grants", "vote_grants"))
