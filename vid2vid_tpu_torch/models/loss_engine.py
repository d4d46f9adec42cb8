"""The GAN loss engine (the reference's Vid2VidModelD), NCHW.

The port of vid2vid_tpu/models/loss_engine.py. It owns the spatial
multiscale PatchGAN `netD`, under --add_face_disc the face PatchGAN
`netD_f` (max(1, num_D - 2) scales), one temporal PatchGAN per temporal
scale (`netD_T[s]`) and VGG19 (`vgg`, frozen), and computes the
reference's loss set (reference: models/vid2vid_model_D.py:93-213):

  G side: G_VGG (fake and raw), G_GAN, G_GAN_Feat, G_Warp, F_Flow, F_Warp,
          W, [G_f_GAN, G_f_GAN_Feat], and per temporal scale G_T_GAN,
          G_T_GAN_Feat, G_T_Warp
  D side: D_real, D_fake, [D_f_real, D_f_fake], and per temporal scale
          D_T_real, D_T_fake

The face losses (pose conditioning) run netD_f on a fixed
(fineSize // 32 * 8)-square crop around the face the conditioning marks
(`face_region`). The JAX package computes them under `lax.cond(found,
...)`; here the box stays on the device (an index-tensor crop) and the
losses are `torch.where(found, loss, 0)`, which gives netD_f and the
generator the same zero gradient where no face was found, without a
readback.

The JAX package holds the discriminators' parameters constant in the G
losses with stop_gradient; here the training steps differentiate each loss
only with respect to its own optimizer group (train/steps.py), and the D
losses take the generated frames detached. The modules' train / eval mode
decides the norms' statistics: the discriminators train with per-batch
statistics and leave the running stats alone (nn/layers.py), as the JAX
package does. Every call runs the discriminators and VGG with cuDNN in
full f32 (utils/precision.py).

Frame tensors arrive flattened over time, (B*T, C, H, W), as the
reference reshapes them before its D calls (reference: train.py:140-145).
"""

from __future__ import annotations

import torch
from torch import nn

from vid2vid_tpu_torch.config import Options
from vid2vid_tpu_torch.losses import (
    feature_matching_loss,
    gan_loss,
    masked_l1,
    vgg_loss,
)
from vid2vid_tpu_torch.nn.discriminator import MultiscaleDiscriminator
from vid2vid_tpu_torch.nn.vgg import Vgg19Features
from vid2vid_tpu_torch.ops.warp import flow_warp
from vid2vid_tpu_torch.utils.precision import cudnn_f32

Losses = dict[str, torch.Tensor]


class LossEngine(nn.Module):
    def __init__(self, opt: Options):
        super().__init__()
        self.opt = opt
        input_nc = opt.label_nc if opt.label_nc != 0 else opt.input_nc
        if opt.use_instance:
            input_nc += 1
        self.d_input_nc = input_nc + opt.output_nc
        td = opt.n_frames_D
        self.dt_input_nc = opt.output_nc * td + 2 * (td - 1)
        interm = not opt.no_ganFeat

        def multiscale(nc, num_d=opt.num_D):
            return MultiscaleDiscriminator(nc, opt.ndf, opt.n_layers_D, opt.norm, num_d, interm)

        self.netD = multiscale(self.d_input_nc)
        self.netD_f = (multiscale(self.d_input_nc, max(1, opt.num_D - 2))
                       if opt.add_face_disc else None)
        self.netD_T = nn.ModuleList(
            multiscale(self.dt_input_nc) for _ in range(opt.n_scales_temporal)
        )
        self.vgg = None if opt.no_vgg else Vgg19Features()

    # ----------------------------------------------------------- primitives

    def _gan_and_fm(self, pred_fake, pred_real):
        opt = self.opt
        g_gan = gan_loss(pred_fake, True, opt.gan_mode, for_discriminator=False)
        g_fm = torch.zeros((), device=pred_fake[0][-1].device)
        if not opt.no_ganFeat:
            g_fm = feature_matching_loss(
                pred_fake, pred_real, opt.num_D, opt.n_layers_D, opt.lambda_feat
            )
        return g_gan, g_fm

    def face_region(self, real_a: torch.Tensor):
        """The face box of a (N, C, H, W) pose conditioning (reference:
        models/vid2vid_model_D.py:215-230): the pixels of DensePose's face
        parts (channel 2 > 0.9), or under --openpose_only those of
        OpenPose's face colour; over all N frames. Returns (found, y0, x0),
        0-d device tensors, the corner of the (fineSize // 32 * 8)-square
        window centred on the box, clamped into the frame."""
        opt = self.opt
        h, w = real_a.shape[-2:]
        size = opt.fineSize // 32 * 8
        if not opt.openpose_only:
            mask = real_a[:, 2] > 0.9
        else:
            r, g, b = real_a[:, 0], real_a[:, 1], real_a[:, 2]
            mask = (r > 0.19) & (r < 0.21) & (g < -0.99) & (b > -0.61) & (b < -0.59)
        found = mask.any()
        big = torch.iinfo(torch.int32).max
        ys = torch.arange(h, device=real_a.device).view(1, h, 1).expand_as(mask)
        xs = torch.arange(w, device=real_a.device).view(1, 1, w).expand_as(mask)
        y_lo, y_hi = torch.where(mask, ys, big).min(), torch.where(mask, ys, -1).max()
        x_lo, x_hi = torch.where(mask, xs, big).min(), torch.where(mask, xs, -1).max()
        yc = torch.clamp((y_lo + y_hi) // 2, size // 2, h - 1 - size // 2)
        xc = torch.clamp((x_lo + x_hi) // 2, size // 2, w - 1 - size // 2)
        return found, yc - size // 2, xc - size // 2

    def _crop_face(self, x: torch.Tensor, y0: torch.Tensor, x0: torch.Tensor):
        """The face window of (N, C, H, W) frames at the device corner (y0,
        x0), start clamped to fit as lax.dynamic_slice clamps it."""
        size = self.opt.fineSize // 32 * 8
        h, w = x.shape[-2:]
        rows = y0.clamp(0, h - size) + torch.arange(size, device=x.device)
        cols = x0.clamp(0, w - size) + torch.arange(size, device=x.device)
        return x.index_select(2, rows).index_select(3, cols)

    def _face_pair(self, real_a, real_b, fake_b):
        """(found, netD_f on the real crop pair, on the fake crop pair)."""
        found, y0, x0 = self.face_region(real_a)
        ra, rb, fb = (self._crop_face(t, y0, x0) for t in (real_a, real_b, fake_b))
        return (found, self.netD_f(torch.cat([ra, rb], 1)),
                self.netD_f(torch.cat([ra, fb], 1)))

    # -------------------------------------------------------------- G losses

    def generator_losses(
        self, real_a, real_b, fake_b, fake_b_raw, real_b_prev, fake_b_prev,
        flow, weight, flow_ref, conf_ref,
    ) -> Losses:
        """Every generator-side spatial loss. Each tensor is (B*T, C, H,
        W); fake_b_raw, flow and weight may be None."""
        opt = self.opt
        zero = torch.zeros((), device=real_b.device)
        losses: Losses = {}
        with cudnn_f32():
            # flow supervision (reference: vid2vid_model_D.py:118-132)
            if flow is not None:
                losses["F_Flow"] = (
                    masked_l1(flow, flow_ref, conf_ref)
                    * opt.lambda_F / (2 ** (opt.n_scales_spatial - 1))
                )
                real_b_warp = flow_warp(real_b_prev, flow)
                losses["F_Warp"] = masked_l1(real_b_warp, real_b, conf_ref) * opt.lambda_T
                losses["W"] = (
                    masked_l1(weight, torch.zeros_like(weight), conf_ref)
                    if opt.no_first_img else zero
                )
            else:
                losses["F_Flow"] = losses["F_Warp"] = losses["W"] = zero

            # VGG perceptual loss on the blended and the raw frames
            if self.vgg is not None:
                g_vgg = vgg_loss(self.vgg, fake_b, real_b) * opt.lambda_feat
                if fake_b_raw is not None:
                    g_vgg = g_vgg + vgg_loss(self.vgg, fake_b_raw, real_b) * opt.lambda_feat
                losses["G_VGG"] = g_vgg
            else:
                losses["G_VGG"] = zero

            # GAN + feature matching on the live fakes
            pred_real = self.netD(torch.cat([real_a, real_b], 1))
            pred_fake = self.netD(torch.cat([real_a, fake_b], 1))
            g_gan, g_fm = self._gan_and_fm(pred_fake, pred_real)
            if fake_b_raw is not None:
                pred_fake_raw = self.netD(torch.cat([real_a, fake_b_raw], 1))
                g2, f2 = self._gan_and_fm(pred_fake_raw, pred_real)
                g_gan, g_fm = g_gan + g2, g_fm + f2
            losses["G_GAN"], losses["G_GAN_Feat"] = g_gan, g_fm

            # warp consistency against the reference flow
            warp_ref = flow_warp(fake_b_prev, flow_ref).detach()
            losses["G_Warp"] = masked_l1(fake_b, warp_ref, conf_ref) * opt.lambda_T

            # the face discriminator's GAN + feature matching, weight 2
            if self.netD_f is not None:
                found, pr, pf = self._face_pair(real_a, real_b, fake_b)
                g, f = self._gan_and_fm(pf, pr)
                losses["G_f_GAN"] = torch.where(found, g * 2.0, zero)
                losses["G_f_GAN_Feat"] = torch.where(found, f * 2.0, zero)
        return losses

    # -------------------------------------------------------------- D losses

    def discriminator_losses(self, real_a, real_b, fake_b, fake_b_raw) -> Losses:
        """D-side losses on detached fakes."""
        opt = self.opt
        with cudnn_f32():
            pred_real = self.netD(torch.cat([real_a, real_b], 1))
            pred_fake = self.netD(torch.cat([real_a, fake_b.detach()], 1))
            d_real = gan_loss(pred_real, True, opt.gan_mode)
            d_fake = gan_loss(pred_fake, False, opt.gan_mode)
            if fake_b_raw is not None:
                pred_fr = self.netD(torch.cat([real_a, fake_b_raw.detach()], 1))
                d_real = d_real + gan_loss(pred_real, True, opt.gan_mode)
                d_fake = d_fake + gan_loss(pred_fr, False, opt.gan_mode)
            losses = {"D_real": d_real, "D_fake": d_fake}
            if self.netD_f is not None:
                found, pr, pf = self._face_pair(real_a, real_b, fake_b.detach())
                zero = torch.zeros((), device=real_b.device)
                losses["D_f_real"] = torch.where(found, gan_loss(pr, True, opt.gan_mode), zero)
                losses["D_f_fake"] = torch.where(found, gan_loss(pf, False, opt.gan_mode), zero)
        return losses

    # ------------------------------------------------------- temporal losses

    @staticmethod
    def _dt_input(frames, flow_ref):
        """(G, tD, 3, H, W) frames + (G, tD-1, 2, H, W) flows -> (G, 3*tD +
        2*(tD-1), H, W), time-major channel blocks, the flows / 20."""
        g, td, c, h, w = frames.shape
        x = frames.reshape(g, td * c, h, w)
        if flow_ref is not None:
            x = torch.cat([x, (flow_ref / 20.0).reshape(g, -1, h, w)], 1)
        return x

    def temporal_g_losses(self, scale_t, real_groups, fake_groups, flow_ref_groups) -> Losses:
        net = self.netD_T[scale_t]
        with cudnn_f32():
            pr = net(self._dt_input(real_groups, flow_ref_groups))
            pf = net(self._dt_input(fake_groups, flow_ref_groups))
            g, f = self._gan_and_fm(pf, pr)
        return {"G_T_GAN": g, "G_T_GAN_Feat": f,
                "G_T_Warp": torch.zeros((), device=g.device)}

    def temporal_d_losses(self, scale_t, real_groups, fake_groups, flow_ref_groups) -> Losses:
        opt = self.opt
        net = self.netD_T[scale_t]
        with cudnn_f32():
            pr = net(self._dt_input(real_groups, flow_ref_groups))
            pf = net(self._dt_input(fake_groups.detach(), flow_ref_groups))
        return {"D_T_real": gan_loss(pr, True, opt.gan_mode),
                "D_T_fake": gan_loss(pf, False, opt.gan_mode)}

    # ------------------------------------------------------------- aggregate

    @staticmethod
    def total_g_loss(losses: Losses, t_losses: list[Losses]) -> torch.Tensor:
        """loss_G as the reference sums it (vid2vid_model_D.py:249-264)."""
        total = (
            losses["G_GAN"] + losses["G_GAN_Feat"] + losses["G_VGG"]
            + losses["G_Warp"] + losses["F_Flow"] + losses["F_Warp"] + losses["W"]
        )
        if "G_f_GAN" in losses:
            total = total + losses["G_f_GAN"] + losses["G_f_GAN_Feat"]
        for tl in t_losses:
            total = total + tl["G_T_GAN"] + tl["G_T_GAN_Feat"] + tl["G_T_Warp"]
        return total

    @staticmethod
    def total_d_loss(losses: Losses) -> torch.Tensor:
        total = (losses["D_fake"] + losses["D_real"]) * 0.5
        if "D_f_fake" in losses:
            total = total + (losses["D_f_fake"] + losses["D_f_real"]) * 0.5
        return total
