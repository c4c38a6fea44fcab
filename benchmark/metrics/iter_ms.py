"""Each AL iteration's time from its start to its end (the session's
``al_iter`` span), averaged over the iterations that overlap the window,
each weighted by its share inside: what a user waits between two label
rounds while sharing the card."""


def read(ctx):
    return None if ctx.mean_s is None else ctx.mean_s * 1e3
