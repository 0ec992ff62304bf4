"""Set-up: from the process's start to the window's opening (loading,
the kernels' build or load, the weights, the cluster, the warm-up)."""


def read(run):
    return run.setup_s
