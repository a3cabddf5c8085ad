"""Host milliseconds the scheduler spent a request sent: the sum of the
engine's ``Metrics`` timers (HP admission, HP admission by preemption, LP
allocation, victim reallocation) over every episode of the window."""


def read(ctx):
    run = ctx["run"]
    sent = len(run.requests)
    if not sent:
        return None
    total = sum(sum(m.t_hp_initial) + sum(m.t_hp_preempt)
                + sum(m.t_lp_alloc) + sum(m.t_realloc) for m in run.metrics)
    return 1e3 * total / sent
