"""kernels.norm_kernel_share: the GroupNorm and LayerNorm calls on CUDA
tensors that reached a hand-written kernel, as a share of all norm calls on
CUDA tensors, over the process, percent. It reads the program's counter
`stablediffusioneo_tpu_torch.ops.norms.route_counts`, calls by (norm,
route): the kernel routes `one_pass`, `pair` and `kernel` over every route
but the CPU's, `plain_cpu` and `flag_cpu` (so over `plain_grad`,
`plain_refused` and the kernel routes). A captured engine adds its calls at
every replay. None where the program keeps no such counter or counted no
call on the card."""

import importlib

KERNEL_ROUTES = ("one_pass", "pair", "kernel")


def read(run):
    try:
        norms = importlib.import_module("stablediffusioneo_tpu_torch.ops.norms")
    except ImportError:
        return None
    counts = getattr(norms, "route_counts", None)
    if not counts:
        return None
    card = sum(n for (_, route), n in counts.items() if not route.endswith("_cpu"))
    if card <= 0:
        return None
    return 100.0 * sum(n for (_, route), n in counts.items() if route in KERNEL_ROUTES) / card
