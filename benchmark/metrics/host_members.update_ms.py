"""Wall ms per AL iteration of the host members' updates
(``member.update`` spans, one a member and user, clipped to the window),
summed over the host workers."""

from benchmark import spans


def read(ctx):
    return spans.per_iteration_ms(ctx, spans.window_wall(ctx,
                                                         "member.update"))
