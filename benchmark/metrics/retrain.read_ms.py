"""Wall ms per AL iteration of the retrain's history reads
(``retrain.read`` spans, clipped to the window): the launching thread
waiting for a member's queued device work to finish."""

from benchmark import spans


def read(ctx):
    return spans.per_iteration_ms(ctx, spans.window_wall(ctx,
                                                         "retrain.read"))
