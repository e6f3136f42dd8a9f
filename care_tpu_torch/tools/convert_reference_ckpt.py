"""Convert a reference (PyTorch Lightning) CARE checkpoint into the port's.

Port of ``misc_tools/convert_reference_ckpt.py``. The reference trains with
pytorch_lightning and saves ``{'state_dict': ..., 'hyper_parameters':
{'opt': ...}}`` (read by ``models/__init__.py:115`` /
``Wrapper.load_from_checkpoint``). This tool maps every torch parameter
into the port's ``Captioner`` tree (``models/transplant.py``) and writes the
port's checkpoint (``training/checkpoints.py:save_checkpoint``: the tree
and its ``.json`` side-car with the opt), which the port serves:

    python -m care_tpu_torch.tools.convert_reference_ckpt best.ckpt \\
        -o best_port.ckpt
    python -m care_tpu_torch.translate -cp best_port.ckpt \\
        --base_data_path /data

Unmapped torch *parameters* (an unsupported sub-module) fail the
conversion unless ``--allow-unmapped`` is given; deterministic buffers
(position ids, sinusoidal tables, BatchNorm step counters) are skipped
silently. ``--from-teacher`` converts the mean teacher
(``teacher_captioner``) of an ``InterplayModel`` checkpoint instead of the
student. The conversion runs on the host.
"""

import argparse
import os

import torch

from care_tpu_torch.models import build_captioner
from care_tpu_torch.models.loading import init_variables_template
from care_tpu_torch.models.transplant import (strip_wrapper_prefix,
                                              transplant_reference_state_dict)
from care_tpu_torch.training.checkpoints import save_checkpoint


def convert(in_path: str, out_path: str, from_teacher: bool = False,
            allow_unmapped: bool = False, verbose: bool = True) -> dict:
    """Returns the conversion report (consumed/buffers/unmapped keys)."""
    ckpt = torch.load(in_path, map_location="cpu", weights_only=False)
    if isinstance(ckpt, dict) and "state_dict" in ckpt:
        state_dict = ckpt["state_dict"]
        hp = ckpt.get("hyper_parameters", {})
        if not isinstance(hp, dict):        # argparse.Namespace
            hp = vars(hp)
        opt = hp.get("opt")
    else:                                   # bare state_dict
        state_dict, opt = ckpt, None
    if opt is None:
        raise SystemExit(
            "checkpoint has no hyper_parameters['opt'] — pass a Lightning "
            "checkpoint saved by the reference's train.py")
    if not isinstance(opt, dict):
        opt = vars(opt)

    selected, other = strip_wrapper_prefix(
        state_dict, source="teacher_captioner" if from_teacher
        else "captioner")
    if from_teacher and not selected:
        raise SystemExit("--from-teacher: checkpoint has no "
                         "teacher_captioner keys (not an InterplayModel run)")

    model = build_captioner(opt, device="cpu")
    template = init_variables_template(model, opt)

    variables, report = transplant_reference_state_dict(
        selected, template, opt, verbose=verbose)
    if report["unmapped"] and not allow_unmapped:
        raise SystemExit(
            f"{len(report['unmapped'])} torch parameters were not mapped "
            f"(first: {report['unmapped'][:5]}); rerun with "
            "--allow-unmapped to convert anyway")

    save_checkpoint(out_path, variables, opt, metadata={
        "converted_from": os.path.abspath(in_path),
        "converted_module": "teacher_captioner" if from_teacher
                            else "captioner",
        "unmapped_torch_keys": report["unmapped"],
    })
    if verbose:
        n = len(report["consumed"])
        extra = (", UNMAPPED: %d" % len(report["unmapped"])
                 if report["unmapped"] else "")
        print(f"wrote {out_path} ({n} torch tensors mapped{extra})")
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("checkpoint", help="reference .ckpt path")
    ap.add_argument("-o", "--out", required=True,
                    help="output path for the port's checkpoint")
    ap.add_argument("--from-teacher", action="store_true",
                    help="convert the mean-teacher (teacher_captioner) copy "
                         "of an InterplayModel checkpoint instead of the "
                         "student")
    ap.add_argument("--allow-unmapped", action="store_true",
                    help="write the checkpoint even if some torch "
                         "parameters could not be mapped")
    args = ap.parse_args(argv)
    convert(args.checkpoint, args.out, from_teacher=args.from_teacher,
            allow_unmapped=args.allow_unmapped)


if __name__ == "__main__":
    main()
