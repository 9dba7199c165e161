"""context_init_s: the host clock around DASContext() in set-up (the
trusted setup from its cache, the FK20 prover's table build)."""


def read(run):
    return run.context_init_s
