"""Training and test-time logging and image dumps, the port of
vid2vid_tpu/utils/visualizer.py (reference: util/visualizer.py).

- console and an append-only <checkpoints_dir>/<name>/loss_log.txt;
- per-epoch image dumps to <name>/web/images and an HTML gallery (train
  time, unless --no_html);
- test-time image saving under results/;
- `--tf_log`: a plain scalars.tsv always, and TensorBoard event files
  (scalars and images) through torch.utils.tensorboard when its backend
  imports.
PIL is imported only where an image file is written, so a run with
--no_html and without --tf_log writes none and needs no PIL.
"""

from __future__ import annotations

import os
import time

from vid2vid_tpu_torch.utils.html import HTMLGallery


class Visualizer:
    def __init__(self, opt):
        self.opt = opt
        self.name = opt.name
        self.win_size = opt.display_winsize
        self.web_dir = os.path.join(opt.checkpoints_dir, opt.name, "web")
        self.img_dir = os.path.join(self.web_dir, "images")
        # the HTML gallery runs only at train time and is disabled by
        # --no_html (reference: util/visualizer.py:18)
        self.use_html = opt.isTrain and not opt.no_html
        if self.use_html:
            os.makedirs(self.img_dir, exist_ok=True)
        else:
            os.makedirs(os.path.join(opt.checkpoints_dir, opt.name), exist_ok=True)
        self.log_name = os.path.join(opt.checkpoints_dir, opt.name, "loss_log.txt")
        with open(self.log_name, "a") as fh:
            fh.write(f"================ Training Loss ({time.strftime('%c')}) ================\n")
        self.scalar_log = (
            os.path.join(opt.checkpoints_dir, opt.name, "scalars.tsv") if opt.tf_log else None
        )
        self.tb = None
        if opt.tf_log:
            try:  # torch ships the writer; the tensorboard package is its backend
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:  # the TSV log stays
                pass
            else:
                self.tb = SummaryWriter(os.path.join(opt.checkpoints_dir, opt.name, "logs"))

    # ------------------------------------------------------------------ loss

    def print_current_errors(self, epoch, i, errors, t):
        msg = f"(epoch: {epoch}, iters: {i}, time: {t:.3f}) "
        msg += " ".join(f"{k}: {v:.3f}" for k, v in errors.items() if v != 0)
        print(msg)
        with open(self.log_name, "a") as fh:
            fh.write(msg + "\n")

    def plot_current_errors(self, errors, step):
        if self.scalar_log:
            with open(self.scalar_log, "a") as fh:
                for k, v in errors.items():
                    fh.write(f"{step}\t{k}\t{v}\n")
        if self.tb is not None:
            for k, v in errors.items():
                self.tb.add_scalar(k, float(v), step)

    def vis_print(self, message):
        print(message)
        with open(self.log_name, "a") as fh:
            fh.write(message + "\n")

    # ---------------------------------------------------------------- images

    def display_current_results(self, visuals: dict, epoch: int, step: int):
        """visuals: {name: uint8 HWC image}; writes the files and refreshes
        the gallery."""
        if self.use_html:
            from PIL import Image
        for label, image in visuals.items():
            if image is None:
                continue
            if self.use_html:
                path = os.path.join(self.img_dir, f"epoch{epoch:03d}_{label}.jpg")
                Image.fromarray(image).save(path)
            if self.tb is not None:
                self.tb.add_image(label, image, step, dataformats="HWC")

        if not self.use_html:
            return
        gallery = HTMLGallery(self.web_dir, f"Experiment name = {self.name}")
        for e in range(epoch, 0, -1):
            gallery.add_header(f"epoch [{e}]")
            ims, txts = [], []
            for label in visuals:
                fname = f"epoch{e:03d}_{label}.jpg"
                if os.path.exists(os.path.join(self.img_dir, fname)):
                    ims.append(os.path.join("images", fname))
                    txts.append(label)
            gallery.add_images(ims, txts, width=self.win_size)
        gallery.save()

    def save_images(self, image_dir, visuals: dict, image_path: str):
        """Test time: save each visual as <frame>_<label>.jpg; returns the
        names written."""
        from PIL import Image

        name = os.path.splitext(os.path.basename(image_path))[0]
        os.makedirs(image_dir, exist_ok=True)
        saved = []
        for label, image in visuals.items():
            if image is None:
                continue
            fname = f"{name}_{label}.jpg"
            Image.fromarray(image).save(os.path.join(image_dir, fname))
            saved.append(fname)
        return saved
