"""Streaming inference engine (the test.py path).

Frames are generated one at a time from a rolling window of tG label maps
and the last tG-1 generated frames; the first tG-1 frames come from a
first-frame strategy: zeros, real frames, or a single-image (pix2pixHD)
generator (`--use_single_G`, with the face-feature lookup for edge2face).

Entry points: `step` (one frame from a raw label window and the state —
true streaming), `generate_clip_raw` (a clip from raw labels, encoded one
frame per step on the card) and `generate_clip` (a whole encoded clip).
Compute-dtype
policy (--bf16 / --fp16): the engine keeps float32 master weights and
casts a copy of the generator, the inputs and the state to bfloat16 at
entry; the frames it returns are float32, the state stays in the compute
dtype. The single-image nets run in float32 whatever the compute dtype,
with cuDNN's TF32 off (`utils/precision.py::cudnn_f32`); only their
frames, on entering the state, take the compute dtype.

--n_devices N > 1 serves on the model axis, as the JAX engine does
(make_mesh(n, data=1)): this process is one of N ranks of a
torch.distributed group, and `step` / `generate_clip_raw` /
`generate_clip` run its columns of every frame (a parallel/halo.py::
WidthShard; the layers exchange their halos) and return the whole frames
on every rank. The weights are replicated (broadcast from rank 0 whenever
any rank's have changed since the last call); the state, the seeding and
the first frames stay whole on every rank. The width must be a multiple
of N, the JAX engine's own condition (halo.check_geometry raises
ValueError otherwise); each coarser level splits by its own rule, its
shards unequal or empty where they must be.
"""

from __future__ import annotations

import copy

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from vid2vid_tpu_torch.config import Options
from vid2vid_tpu_torch.models.generator import ClipOutputs, State, Vid2VidGenerator
from vid2vid_tpu_torch.nn.factory import single_input_nc
from vid2vid_tpu_torch.nn.layers import state_tensors, version_key
from vid2vid_tpu_torch.nn.pix2pixhd import (
    Encoder,
    GlobalGenerator,
    GlobalWithFeatures,
    LocalEnhancer,
)
from vid2vid_tpu_torch.parallel import halo
from vid2vid_tpu_torch.parallel.mesh import Mesh, make_mesh, replicated, visible_devices
from vid2vid_tpu_torch.utils.device import require_device
from vid2vid_tpu_torch.utils.precision import cudnn_f32
from vid2vid_tpu_torch.utils.profiling import INPUT, STEP, span


def make_single_image_generator(opt: Options) -> tuple[nn.Module, bool]:
    """The single-image generator of the first frames, by dataset and
    loadSize as the reference hard-codes it (vid2vid_model_G.py:261-288):
    (module, needs_features). Cityscapes: GlobalGenerator (ngf 64, 3 / 4
    downsamples at loadSize 512 / 1024) or LocalEnhancer (ngf 32, 4) at
    2048; face: GlobalWithFeatures (16 features, ngf 64, 3), fed by an
    Encoder. Instance norm, 9 blocks (3 local). Raises ValueError for any
    other dataroot or loadSize."""
    root = opt.dataroot.lower()
    n_in = single_input_nc(opt)
    if "city" in root:
        if opt.loadSize in (512, 1024):
            nd = 3 if opt.loadSize == 512 else 4
            return GlobalGenerator(n_in, ngf=64, n_downsampling=nd, norm="instance"), False
        if opt.loadSize == 2048:
            return LocalEnhancer(n_in, ngf=32, n_downsample_global=4, norm="instance"), False
        raise ValueError(f"no single-image generator for loadSize {opt.loadSize}")
    if "face" in root:
        return (
            GlobalWithFeatures(n_in, feat_num=16, ngf=64, n_downsampling=3, norm="instance"),
            True,
        )
    raise ValueError(f"no single-image generator for dataroot {opt.dataroot!r}")


def serving_mesh(opt: Options, device: torch.device) -> Mesh | None:
    """The model-axis mesh of --n_devices: n = min(n_devices, the devices
    visible) with the JAX package's warning, then make_mesh(n, data=1); None
    for one device. Raises for n > 1 without a process group of world n."""
    n = visible_devices(getattr(opt, "n_devices", 1), device)
    if n == 1:
        return None
    if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() != n:
        raise RuntimeError(
            f"--n_devices {n}: no process group of {n} ranks. Run test_cli with "
            f"--n_devices {n} (it starts the ranks), or torchrun --nproc_per_node {n}, "
            "or build the engine in each rank of vid2vid_tpu_torch.parallel.launch")
    return make_mesh(n, data=1)


class InferenceEngine:
    """Inference wrapper around a Vid2VidGenerator on one device: the first
    CUDA device unless the caller passes device='cpu'. With --n_devices N >
    1, one rank of a model axis of N (`serving_mesh`)."""

    def __init__(self, opt: Options, device: torch.device | str = "cuda"):
        self.opt = opt
        self.device = require_device(device)
        self.mesh = serving_mesh(opt, self.device)
        self._synced: list | None = None  # version_key of gen at the last broadcast
        self.compute_dtype = (
            torch.bfloat16 if (opt.bf16 or opt.fp16) else torch.float32
        )
        self.gen = Vid2VidGenerator(opt).to(self.device).eval()
        self._compute_gen: tuple | None = None  # (version_key, the cast copy)
        self.single_g: nn.Module | None = None  # build_single_g
        self.single_needs_feat = False
        self.encoder: Encoder | None = None
        self.feature_clusters: dict | None = None  # faces: the training clusters

    # ---------------------------------------------------------------- weights

    def load_state_dict(self, state_dict: dict, strict: bool = True):
        """Load master weights (reference names with a G{s}. prefix)."""
        return self.gen.load_state_dict(state_dict, strict=strict)

    def compute_generator(self) -> Vid2VidGenerator:
        """The generator in the compute dtype: a cast copy of the master
        weights, made anew whenever a parameter or buffer of `gen` has
        changed since (its version, storage, dtype or device:
        `nn.layers.version_key`), however it was changed."""
        if self.compute_dtype == torch.float32:
            return self.gen
        key = version_key(state_tensors(self.gen))
        if self._compute_gen is None or self._compute_gen[0] != key:
            self._compute_gen = (
                key, copy.deepcopy(self.gen).to(self.compute_dtype).eval())
        return self._compute_gen[1]

    # -------------------------------------------------------------- model axis

    def shard(self, width: int, height: int) -> halo.WidthShard | None:
        """This rank's columns of frames `width` x `height` (None without a
        model axis); raises ValueError for a width the ranks cannot split
        (halo.check_geometry)."""
        if self.mesh is None:
            return None
        n = self.mesh.model
        halo.check_geometry(width, n)
        return halo.make_shard(self.mesh.model_index, n, width, self.mesh.model_group, height)

    def replicate_weights(self) -> None:
        """Broadcast the generator's weights from rank 0 of the model axis
        when any rank's have changed since the last broadcast (one small
        all_reduce a call to learn it)."""
        key = version_key(state_tensors(self.gen))
        changed = torch.tensor([float(key != self._synced)], device=self.device)
        dist.all_reduce(changed, op=dist.ReduceOp.MAX, group=self.mesh.model_group)
        if changed.item():
            replicated(self.gen, group=self.mesh.model_group)
            self._synced = version_key(state_tensors(self.gen))

    def _sharded(self, width: int, height: int) -> halo.WidthShard | None:
        """The shard of a call on frames `width` x `height`, the weights
        replicated first."""
        shard = self.shard(width, height)
        if shard is not None:
            self.replicate_weights()
        return shard

    # ----------------------------------------------------------------- encode

    def encode(self, labels: torch.Tensor, inst: torch.Tensor | None = None):
        with span(INPUT):
            return self.gen.encode_input(
                labels.to(self.device), None if inst is None else inst.to(self.device)
            )

    # ------------------------------------------------------------ first frame

    def initial_state(
        self,
        batch: int,
        height: int,
        width: int,
        real_frames: torch.Tensor | None = None,
    ) -> State:
        """Seed state: real frames when given, else zeros.

        real_frames: (B, >= tG-1, 3, H, W); its first tG-1 frames are used.
        """
        if real_frames is not None:
            return self.seed_state(real_frames[:, : self.opt.n_frames_G - 1])
        return self.gen.zero_state(
            batch, height, width, device=self.device, dtype=self.compute_dtype
        )

    @torch.no_grad()
    def seed_state(self, frames: torch.Tensor) -> State:
        """Ring buffers (a pyramid) from (B, tG-1, 3, H, W) frames."""
        return self.gen.state_from_frames(
            frames.to(self.device, self.compute_dtype)
        )

    # ------------------------------------------------------ single-image G

    def build_single_g(self, sg_cfg: dict | None = None) -> nn.Module:
        """Build the single-image first-frame generator for this opt (and,
        for faces, the feature Encoder) on the engine's device, in f32 and
        eval mode, with PyTorch's initialisation: the caller loads weights.

        sg_cfg overrides the registry's dims with {'feat_num', 'g': {ngf,
        nd, nb, norm}, 'e': {out_nc, ngf, nd, norm}}: a GlobalWithFeatures
        and an Encoder, as the JAX package's build_single_g takes it.
        """
        if sg_cfg is not None:
            g, e = sg_cfg["g"], sg_cfg["e"]
            self.single_g = GlobalWithFeatures(
                single_input_nc(self.opt), feat_num=sg_cfg["feat_num"], ngf=g["ngf"],
                n_downsampling=g["nd"], n_blocks=g.get("nb", 9), norm=g["norm"])
            self.single_needs_feat = True
            self.encoder = Encoder(output_nc=e["out_nc"], ngf=e["ngf"],
                                   n_downsampling=e["nd"], norm=e["norm"])
        else:
            self.single_g, self.single_needs_feat = make_single_image_generator(self.opt)
            self.encoder = (Encoder(output_nc=16, ngf=16, n_downsampling=4, norm="instance")
                            if self.single_needs_feat else None)
        if self.encoder is not None:
            self.encoder = self.encoder.to(self.device).eval()
        self.single_g = self.single_g.to(self.device).eval()
        return self.single_g

    @torch.no_grad()
    def single_g_first_frames(
        self,
        enc_first: torch.Tensor,
        real_first: torch.Tensor | None = None,
        pool_map: torch.Tensor | None = None,
        feature_clusters: dict | None = None,
    ) -> State:
        """The state seeded with tG-1 frames of the single-image generator.

        enc_first: (B, tG-1, C, H, W) encoded label maps; the instance-edge
        channel is dropped (reference: vid2vid_model_G.py:239-240). Faces
        also take the first real frames (B, tG-1, 3, H, W), the part maps
        (B, tG-1, H, W) and the training clusters (`face_features`). The
        nets run in f32 with cuDNN's TF32 off; the state takes the compute
        dtype.
        """
        opt = self.opt
        frames = []
        with cudnn_f32():
            for i in range(opt.n_frames_G - 1):
                x = enc_first[:, i].to(self.device, torch.float32)
                if opt.label_nc > 0 and opt.use_instance:
                    x = x[:, : opt.label_nc]
                if self.single_needs_feat:
                    feat = self.face_features(real_first[:, i], pool_map[:, i],
                                              feature_clusters)
                    frames.append(self.single_g(x, feat))
                else:
                    frames.append(self.single_g(x))
        return self.seed_state(torch.stack(frames, 1))

    @torch.no_grad()
    def face_features(
        self, real_image: torch.Tensor, inst: torch.Tensor, feature_clusters: dict
    ) -> torch.Tensor:
        """Instance features snapped to the nearest training image's clusters
        (reference: vid2vid_model_G.py:290-320 and base_model.py:136-144).

        real_image: (B, 3, H, W); inst: (B, H, W) part ids;
        feature_clusters: {part id: (n_images, feat_num + 1) array}. Encode
        the image, take the encoding at the first pixel (row-major) of each
        part present in both inst and the clusters, pick ONE training image
        by the squared distance summed over all those parts and features
        (a joint argmin, not one per part), and fill each part's pixels of
        the first image with that image's row (clamped per part). Returns
        (B, feat_num, H, W) float32 on the engine's device, zero where no
        part is; absent parts add nothing to the distance. The Encoder runs
        in f32 with cuDNN's TF32 off. An empty dict
        gives zeros of the Encoder's width (the JAX package raises
        StopIteration there).
        """
        real = real_image.to(self.device, torch.float32)
        inst_dev = inst.to(self.device)
        clusters = {int(k): np.asarray(v) for k, v in feature_clusters.items()}
        feat_num = (next(iter(clusters.values())).shape[1] - 1 if clusters
                    else self.encoder.output_nc)
        with cudnn_f32():
            enc = self.encoder(real, inst_dev).cpu().numpy()
        inst_np = inst_dev.cpu().numpy().astype(np.int64)
        out = np.zeros((inst_np.shape[0], feat_num) + inst_np.shape[1:3], np.float32)
        present = [int(p) for p in np.unique(inst_np) if int(p) in clusters]
        if present:
            num_images = min(clusters[p].shape[0] for p in present)
            dists = np.zeros((num_images,), np.float64)
            masks = {}
            for part in present:
                masks[part] = inst_np[0] == part
                y, x = np.argwhere(masks[part])[0]  # first pixel, row-major
                ref = clusters[part][:num_images, :feat_num]
                dists += ((ref - enc[0, :feat_num, y, x]) ** 2).sum(-1)
            best = int(np.argmin(dists))
            for part in present:
                row = clusters[part][min(best, len(clusters[part]) - 1), :feat_num]
                out[0][:, masks[part]] = row[:, None]
        return torch.from_numpy(out).to(self.device)

    # ------------------------------------------------------------------- clip

    @torch.no_grad()
    def generate_clip(
        self, enc_a: torch.Tensor, state: State, use_raw_only: bool = False
    ) -> tuple[ClipOutputs, State]:
        """(B, T+tG-1, C, H, W) encoded labels -> (ClipOutputs in f32, state)."""
        dt = self.compute_dtype
        shard = self._sharded(enc_a.shape[-1], enc_a.shape[-2])
        with span(INPUT):
            enc_a = enc_a.to(self.device, dt)
            state = tuple(s.to(self.device, dt) for s in state)
        outs, new_state = self.compute_generator().generate_clip(
            enc_a, state, use_raw_only=use_raw_only, shard=shard)
        return (
            ClipOutputs(*(None if o is None else o.float() for o in outs)),
            new_state,
        )

    @torch.no_grad()
    def generate_clip_raw(
        self, labels: torch.Tensor, inst: torch.Tensor | None, state: State,
        use_raw_only: bool = False,
    ) -> tuple[ClipOutputs, State]:
        """A clip from RAW labels (B, T+tG-1, H, W) (float maps (B, T+tG-1,
        C, H, W) when label_nc == 0) and instance maps, or inst=None:
        `Vid2VidGenerator.generate_clip_streaming` on the compute-dtype
        generator. The labels may stay on the host (one frame a step moves
        to the card). Returns (ClipOutputs in f32, state in the compute
        dtype). With a model axis each rank encodes and runs its columns;
        the outputs are whole on every rank."""
        dt = self.compute_dtype
        shard = self._sharded(labels.shape[-1], labels.shape[-2])
        outs, new_state = self.compute_generator().generate_clip_streaming(
            labels, inst, tuple(s.to(self.device, dt) for s in state),
            use_raw_only=use_raw_only, compute_dtype=dt, shard=shard,
        )
        return (
            ClipOutputs(*(None if o is None else o.float() for o in outs)),
            new_state,
        )

    # ------------------------------------------------------------------- step

    @torch.no_grad()
    def step(
        self,
        labels_window: torch.Tensor,
        inst_window: torch.Tensor | None,
        state: State,
        use_raw_only: bool = False,
    ) -> tuple[torch.Tensor, State]:
        """One frame from a raw (B, tG, H, W) label window and the state.

        Returns the (B, 3, H, W) float32 frame and the new state. With a
        model axis it is `generate_clip_raw` of the window (each rank
        encodes its columns); the frame is whole on every rank.
        """
        with span(STEP):
            if self.mesh is not None:
                outs, new_state = self.generate_clip_raw(labels_window, inst_window, state,
                                                         use_raw_only)
                return outs.fake[:, 0], new_state
            enc = self.encode(labels_window, inst_window)
            outs, new_state = self.generate_clip(enc, state, use_raw_only)
            return outs.fake[:, 0], new_state
