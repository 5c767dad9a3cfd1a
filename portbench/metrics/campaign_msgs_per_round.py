"""Campaign messages a round: the pre-vote and vote requests the route
took from the outboxes over a ``--trace 1`` window (the program's
election census), delivered or dropped to a cut peer alike, over the
window's rounds.  In a churn cell most are the isolated replicas'
pre-votes, which find no quorum."""
from portbench.metrics._census import per_round


def read(ctx):
    return per_round(ctx, ("prevote_requests", "vote_requests"))
