"""Device and pinned allocations, allocator retries and kernel builds
after set-up's warm mark (the program's post-warm-up sentry,
``analysis/jitcheck.Sentry``): each is a stall the set-up should have
paid for."""


def read(ctx):
    return ctx["allocs_after_warm"]
