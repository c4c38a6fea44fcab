"""Process start to the window's opening: imports, the inputs, the host
members' fits, the host core's build on a checkout's first run, the
engine and the warm-up (every first user's baseline evaluation and first
iteration)."""


def read(ctx):
    return ctx.setup_s
