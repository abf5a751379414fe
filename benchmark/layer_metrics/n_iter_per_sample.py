"""Mean N_ITER over every sample of the window, from the rounds'
tokens: the work a round asks of the convergence kernel.  It moves
only where the math or its rounding changed."""


def read(run):
    w = run["work"]
    return w["iters"] / w["samples"] if w.get("samples") else None
