"""What the benchmark takes from the program, ``care_tpu_torch``: its
options, its model filled with the benchmark's weights, and its counters.
Nothing here reads the JAX package.
"""

import re
import sys
import time

import torch


def program_opt(cfg: dict, extra: dict = None) -> dict:
    """The program's options for a configuration file, checked against the
    sizes the file states (the reference reads those)."""
    from care_tpu_torch.config import get_opt
    opt = get_opt(dict(cfg["get_opt"]), read_vocab=False, resolve_paths=False)
    opt.update(cfg.get("set", {}))
    opt.update(extra or {})
    m = cfg["model"]
    wrong = {k: (opt[k], v) for k, v in m.items()
             if k in opt and not isinstance(v, dict) and opt[k] != v}
    wrong.update({f"dim_{c}": (opt[f"dim_{c}"], d)
                  for c, d in m["dims"].items() if opt[f"dim_{c}"] != d})
    if opt["n_frames"] != m["rows"]["a"]:
        wrong["n_frames"] = (opt["n_frames"], m["rows"]["a"])
    if opt["retrieval_topk"] != m["rows"]["r"]:
        wrong["retrieval_topk"] = (opt["retrieval_topk"], m["rows"]["r"])
    if wrong:
        raise RuntimeError(f"{cfg['name']}: the program's options differ "
                           f"from the configuration (program, file): {wrong}")
    return opt


def fill_model(model: torch.nn.Module, weights: dict) -> None:
    """Load the benchmark's weights into the program's model; every name
    and shape has to match."""
    sd = model.state_dict()
    mismatch = sorted(set(sd) ^ set(weights)) + sorted(
        k for k in set(sd) & set(weights) if sd[k].shape != weights[k].shape)
    if mismatch:
        raise RuntimeError(f"the program's parameters differ from the "
                           f"reference's: {mismatch[:8]}")
    model.load_state_dict(weights)


def build_model(opt: dict, weights: dict, device):
    """The program's Captioner in eval mode on ``device``, holding a copy
    of ``weights``."""
    from care_tpu_torch.models import build_captioner
    model = build_captioner(opt, device=device)
    fill_model(model, weights)
    return model


# the program's counters: a kernel's launches, a loop's steps or passes, a
# table's lookups
COUNTER = re.compile(r"(launches|_steps|_passes|lookups)$")
LAUNCHES = re.compile(r"launches$")


def _ints(names_values, prefix: str, pattern) -> dict:
    return {f"{prefix}.{k}": v for k, v in names_values
            if pattern.search(k) and type(v) is int}


def counters(**holders) -> dict:
    """Every counter of the program as it stands: each module-level
    ``*launches`` integer of its loaded modules, keyed by the module's path
    inside the package (``ops.fused_head_topk.launches``), and each
    counter attribute of the objects a driver holds, keyed by their role
    (``translator.beam_steps``, ``translator.decoder_passes``,
    ``bank.lookups``)."""
    out = {}
    for name, mod in list(sys.modules.items()):
        if name.startswith("care_tpu_torch.") and mod is not None:
            out.update(_ints(list(vars(mod).items()),
                             name[len("care_tpu_torch."):], LAUNCHES))
    for role, obj in holders.items():
        if obj is not None:
            out.update(_ints(list(vars(obj).items()), role, COUNTER))
    return out


def delta(after: dict, before: dict) -> dict:
    return {k: after[k] - before.get(k, 0) for k in after}


class Marks:
    """Seconds of each part of a set-up, each closed by a synchronise."""

    def __init__(self, device):
        self.device, self.parts = device, {}
        self.t = time.perf_counter()

    def __call__(self, name: str) -> None:
        sync(self.device)
        now = time.perf_counter()
        self.parts[name] = now - self.t
        self.t = now


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
