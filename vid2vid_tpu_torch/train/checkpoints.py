"""Checkpoint save / restore and the warm-start, the port of
vid2vid_tpu/train/checkpoints.py in the reference's file layout
(reference: models/base_model.py:43-48, models/models.py:105-110).

Under <checkpoints_dir>/<name>/:
  <tag>_net_G<s>.pth    one per spatial scale: that scale's state_dict
                        without its `G<s>.` prefix (what test_cli.py reads);
  <tag>_net_D.pth       the spatial discriminator;
  <tag>_net_D_f.pth     the face discriminator (--add_face_disc);
  <tag>_net_D_T<s>.pth  one per temporal scale;
  <tag>_optim.pth       the three Adam state dicts (the D one over netD's
                        and netD_f's parameters) and the schedule
                        counters (the JAX package's payload, field for
                        field; the reference kept no optimizer state);
  iter.txt              "epoch epoch_iter".
VGG is frozen and not saved. Tensors go to the CPU before `torch.save`;
each file is written beside its name and renamed over it, and the
optimizer file, written last, marks a checkpoint complete. Loads use
`weights_only=True`.

Restores work in place: `load_state_dict` into the modules and optimizers
the caller holds, so the optimizers' states and the packed-weight caches
keyed by nn/layers.py::version_key see the restored tensors.
"""

from __future__ import annotations

import os

import torch

from vid2vid_tpu_torch.train.state import Schedule, TrainState
from vid2vid_tpu_torch.utils.device import to_cpu

SCHEDULE_FIELDS = (
    "epoch", "epoch_iter", "total_steps", "n_frames_total", "n_frames_per_dev",
    "n_frames_load", "n_frames_bp", "seq_len_max", "finetune_all",
)


def checkpoint_path(opt, tag: str, what: str) -> str:
    """<checkpoints_dir>/<name>/<tag>_<what>.pth"""
    return os.path.join(opt.checkpoints_dir, opt.name, f"{tag}_{what}.pth")


def _load(path: str):
    return torch.load(path, map_location="cpu", weights_only=True)


def schedule_fields(schedule: Schedule) -> dict:
    return {f: getattr(schedule, f) for f in SCHEDULE_FIELDS}


def checkpoint_payloads(state: TrainState, schedule: Schedule) -> dict:
    """{file name's <what>: payload} of one checkpoint; the optimizer file
    comes last."""
    gen, engine = state.gen, state.engine
    files = {f"net_G{s}": gen.scale(s).state_dict() for s in range(gen.n_scales)}
    files["net_D"] = engine.netD.state_dict()
    if engine.netD_f is not None:
        files["net_D_f"] = engine.netD_f.state_dict()
    files.update({f"net_D_T{s}": net.state_dict() for s, net in enumerate(engine.netD_T)})
    files["optim"] = {
        "opt_g": state.opt_g.state_dict(),
        "opt_d": state.opt_d.state_dict(),
        "opt_dt": [o.state_dict() for o in state.opt_dt],
        "schedule": schedule_fields(schedule),
    }
    return files


def write_checkpoint(opt, files: dict, tag: str = "latest") -> None:
    """Write `checkpoint_payloads`' files, then iter.txt."""
    root = os.path.join(opt.checkpoints_dir, opt.name)
    os.makedirs(root, exist_ok=True)
    for what, payload in files.items():
        path = checkpoint_path(opt, tag, what)
        torch.save(to_cpu(payload), path + ".part")
        os.replace(path + ".part", path)
    sched = files["optim"]["schedule"]
    with open(os.path.join(root, "iter.txt"), "w") as fh:
        fh.write(f"{sched['epoch']} {sched['epoch_iter']}")


def save_checkpoint(opt, state: TrainState, schedule: Schedule, tag: str = "latest") -> None:
    """Save the weights (but VGG's), the three optimizers and the schedule."""
    write_checkpoint(opt, checkpoint_payloads(state, schedule), tag)


def checkpoint_exists(opt, tag: str = "latest") -> bool:
    return os.path.exists(checkpoint_path(opt, tag, "optim"))


def restore_checkpoint(opt, state: TrainState, schedule: Schedule, tag: str = "latest"):
    """Restore a checkpoint into `state`'s modules and optimizers and into
    `schedule`, in place; returns (state, schedule)."""
    optim = _load(checkpoint_path(opt, tag, "optim"))
    for f in SCHEDULE_FIELDS:
        setattr(schedule, f, type(getattr(schedule, f))(optim["schedule"][f]))
    gen, engine = state.gen, state.engine
    for s in range(gen.n_scales):
        gen.scale(s).load_state_dict(_load(checkpoint_path(opt, tag, f"net_G{s}")))
    engine.netD.load_state_dict(_load(checkpoint_path(opt, tag, "net_D")))
    if engine.netD_f is not None:
        engine.netD_f.load_state_dict(_load(checkpoint_path(opt, tag, "net_D_f")))
    for s, net in enumerate(engine.netD_T):
        net.load_state_dict(_load(checkpoint_path(opt, tag, f"net_D_T{s}")))
    n_saved = len(optim["opt_d"]["param_groups"][0]["params"])
    n_held = len(state.opt_d.param_groups[0]["params"])
    if n_saved != n_held:
        raise ValueError(
            f"the checkpoint's D optimizer holds {n_saved} parameters, the state's "
            f"{n_held} (netD and netD_f: is --add_face_disc the same?)")
    state.opt_g.load_state_dict(optim["opt_g"])
    state.opt_d.load_state_dict(optim["opt_d"])
    if len(optim["opt_dt"]) != len(state.opt_dt):
        raise ValueError(
            f"the checkpoint has {len(optim['opt_dt'])} D_T optimizers, the state "
            f"{len(state.opt_dt)}")
    for o, sd in zip(state.opt_dt, optim["opt_dt"]):
        o.load_state_dict(sd)
    return state, schedule


def fuzzy_merge(template: dict, loaded: dict) -> tuple[dict, int, list[str]]:
    """The reference's fallback of load_network (models/base_model.py:76-107):
    take the entries of `loaded` whose name and shape match `template`, keep
    the template's elsewhere. Returns (merged, n_loaded, skipped keys)."""
    merged, skipped = {}, []
    for k, v in template.items():
        if k not in loaded:
            merged[k] = v
            skipped.append(k)
        elif tuple(loaded[k].shape) != tuple(v.shape):
            merged[k] = v
            skipped.append(f"{k} (shape {tuple(loaded[k].shape)} != {tuple(v.shape)})")
        else:
            merged[k] = loaded[k]
    return merged, len(template) - len(skipped), skipped


def load_pretrain(opt, state: TrainState) -> TrainState:
    """Warm-start from another run's checkpoint directory (--load_pretrain),
    in place: a full checkpoint (`latest_net_G*.pth` and `latest_net_D*.pth`)
    or a generator-only one. Entries whose name or shape do not match (a
    new enhancer scale) stay at init, as the reference's fuzzy
    load_network leaves them (scripts/street/train_1024.sh:5); a face
    discriminator loads from `latest_net_D_f.pth` where there is one."""
    root, tag = os.path.abspath(opt.load_pretrain), "latest"
    src = opt.replace(checkpoints_dir=os.path.dirname(root), name=os.path.basename(root))
    if not os.path.exists(checkpoint_path(src, tag, "net_G0")):
        raise FileNotFoundError(
            f"--load_pretrain {opt.load_pretrain}: no {tag}_net_G0.pth under {root}")

    def scales(prefix: str, what: str) -> dict:
        loaded, s = {}, 0
        while os.path.exists(path := checkpoint_path(src, tag, f"{what}{s}")):
            loaded.update({f"{prefix}{s}.{k}": v for k, v in _load(path).items()})
            s += 1
        return loaded

    gen, engine = state.gen, state.engine
    merged, n_g, skipped = fuzzy_merge(gen.state_dict(), scales("G", "net_G"))
    gen.load_state_dict(merged)
    msg = f"load_pretrain: {n_g} generator tensors from {root}"
    if os.path.exists(checkpoint_path(src, tag, "net_D")):
        d_loaded = {f"netD.{k}": v for k, v in _load(checkpoint_path(src, tag, "net_D")).items()}
        if os.path.exists(path := checkpoint_path(src, tag, "net_D_f")):
            d_loaded.update({f"netD_f.{k}": v for k, v in _load(path).items()})
        d_loaded.update(scales("netD_T.", "net_D_T"))
        template = {k: v for k, v in engine.state_dict().items() if not k.startswith("vgg.")}
        merged, n_d, skipped_d = fuzzy_merge(template, d_loaded)
        engine.load_state_dict(merged, strict=False)
        skipped += skipped_d
        msg += f", {n_d} discriminator tensors"
    print(msg)
    if skipped:
        print(f"  not initialized from pretrain ({len(skipped)}):")
        for s in skipped[:12]:
            print(f"    {s}")
        if len(skipped) > 12:
            print(f"    ... +{len(skipped) - 12} more")
    return state
