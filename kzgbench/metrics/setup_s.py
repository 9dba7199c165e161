"""setup_s: the whole set-up of a run, from the command's first line to the
end of the warm-up calls (imports, kernels from the build cache, the context
on the embedded setup, the input pool, the warm-up), by the host clock."""


def read(run):
    return run.setup_s
