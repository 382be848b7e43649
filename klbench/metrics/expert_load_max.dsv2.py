"""How uneven the routing is: the busiest expert's (token, choice) pairs
over the mean an expert gets (routed pairs / experts), averaged over the
MoE calls of the traced window, from the program's counters
(``moe.EXPERT_LOAD``, kept on the device while spans are on and read by
the loop after the window). 1 is even; the busiest expert's share of the
grouped products' time grows with it."""


def read(view, ctx):
    load = ctx.get("expert_load")
    if not load:
        return None
    n = ctx["n_experts"]
    return sum(busiest * n / pairs for pairs, busiest in load) / len(load)
