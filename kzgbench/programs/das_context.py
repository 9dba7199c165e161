"""The port's PeerDAS context, as a configuration states it:
`DASContext(use_precomp=<precomp_width>, **program.kwargs)` on the embedded
mainnet trusted setup, after every kernel is built or loaded from its build
cache. `precomp_width` null is the table-free route; `kwargs` may name the
constructor's other options (`table_cache`, `trusted_setup` excepted).

A program module gives `build(configuration, phase)`, which calls
`phase(name)` at the end of each part of its set-up, and the program's
counters for the traced run: `kernels()`, `reset_launches()`, `launches()`.
"""


def build(configuration: dict, phase):
    import torch

    from rust_eth_kzg_tpu_torch import DASContext
    from rust_eth_kzg_tpu_torch.ops import kernels as PK

    phase("import_program")
    PK.build_all()
    phase("kernels_built_or_loaded")
    program = DASContext(use_precomp=configuration["precomp_width"],
                         **configuration["program"].get("kwargs", {}))
    torch.cuda.synchronize()
    phase("context_init")
    return program


def kernels() -> list[str]:
    from rust_eth_kzg_tpu_torch.ops import kernels as PK

    return list(PK.KERNELS)


def reset_launches() -> None:
    from rust_eth_kzg_tpu_torch.ops import kernels as PK

    PK.reset_launches()


def launches() -> dict[str, int]:
    from rust_eth_kzg_tpu_torch.ops import kernels as PK

    return {k: v for k, v in PK.LAUNCHES.items() if v}
