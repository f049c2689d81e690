"""bwo_evolve_launches_per_round (1): the port's own launch counter
(``kernels/bwo_evolve``; a replayed graph adds the launches it holds)
over the traced rounds."""


def read(ctx):
    t = ctx.trace
    if t is None or ctx.traffic["strategy"] != "fedbwo" or t.launches <= 0:
        return None
    return t.launches / t.rounds
