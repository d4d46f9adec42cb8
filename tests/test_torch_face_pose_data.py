"""The port's face and pose data (data/raster.py, keypoints.py, face.py,
pose.py, the transforms' array path) against cv2, PIL and the JAX package.

The rasters are held to cv2 / PIL; the items of FaceDataset / PoseDataset
and of their test streams to the JAX package's under the same seed (JAX's
global generators seeded as tests/test_torch_data.py seeds them; the port
draws from the dataset's own). The trees are written here with PIL from
the seeded generators of data/synthetic.py.
"""

import json
import os
import random
import sys

import cv2
import numpy as np
import pytest
from PIL import Image

from test_torch_data import jax_globals
from vid2vid_tpu.config import Options as JaxOptions
from vid2vid_tpu.data import face as jax_face
from vid2vid_tpu.data import keypoints as jax_keypoints
from vid2vid_tpu.data import pose as jax_pose
from vid2vid_tpu.data.loader import create_dataset as jax_create_dataset
from vid2vid_tpu.data.loader import create_test_stream as jax_create_test_stream
from vid2vid_tpu_torch.config import Options
from vid2vid_tpu_torch.data import face, keypoints, pose, raster, synthetic, transforms
from vid2vid_tpu_torch.data.loader import create_dataset, create_test_stream

SEED = 4


# ------------------------------------------------------------- the trees


def write_face_tree(root, phase="train", n_seqs=2, n_frames=4, hw=(96, 128), seed=0,
                    width=24):
    """{phase}_keypoints/seqK/sKfNN.txt (68 "x,y" rows) and {phase}_img/seqK/
    sKfNN.png, faces `width` wide (crop boxes of ~2.5 width); sequence 1's
    frame 1 has a closed mouth (an empty chain)."""
    rng = np.random.default_rng(seed)
    h, w = hw
    for s in range(n_seqs):
        for sub in ("keypoints", "img"):
            os.makedirs(os.path.join(root, f"{phase}_{sub}", f"seq{s}"), exist_ok=True)
        for k in range(n_frames):
            pts = synthetic.face_landmarks(rng, w / 2 + 3 * k, h / 2 - 4, width,
                                           mouth_open=0.0 if (s, k) == (1, 1) else 0.4)
            np.savetxt(os.path.join(root, f"{phase}_keypoints", f"seq{s}", f"s{s}f{k:02d}.txt"),
                       pts, delimiter=",")
            Image.fromarray(synthetic.face_image(rng, h, w, pts)).save(
                os.path.join(root, f"{phase}_img", f"seq{s}", f"s{s}f{k:02d}.png"))


def write_pose_tree(root, phase="train", n_seqs=2, n_frames=5, hw=(96, 128), seed=0,
                    faceless=(1,)):
    """{phase}_img/, {phase}_densepose/ (IUV png) and {phase}_openpose/
    (JSON) per sequence; the sequences in `faceless` have no face parts."""
    rng = np.random.default_rng(seed)
    h, w = hw
    for s in range(n_seqs):
        for sub in ("img", "densepose", "openpose"):
            os.makedirs(os.path.join(root, f"{phase}_{sub}", f"seq{s}"), exist_ok=True)
        for k in range(n_frames):
            cx, top, height = w / 2 + 2 * k, 4, h - 8
            iuv = synthetic.densepose_iuv(rng, h, w, cx, top, height, face=s not in faceless)
            people = [synthetic.openpose_person(rng, cx, top, height)]
            Image.fromarray(iuv).save(os.path.join(root, f"{phase}_densepose", f"seq{s}", f"s{s}f{k:02d}.png"))
            with open(os.path.join(root, f"{phase}_openpose", f"seq{s}", f"s{s}f{k:02d}.json"), "w") as fh:
                json.dump({"people": people}, fh)
            img = synthetic.face_image(rng, h, w, np.array([[cx - 5, top], [cx + 5, top + 12]]))
            Image.fromarray(img).save(os.path.join(root, f"{phase}_img", f"seq{s}", f"s{s}f{k:02d}.png"))


def both(**kw):
    return JaxOptions(**kw), Options(**kw)


# ------------------------------------------------------------ the rasters


def _polygons(rng, n_cases):
    """In-image polygons: random, with repeated and collinear points, and
    the face part polygons of seeded landmarks."""
    out = []
    for i in range(n_cases):
        h, w = (int(v) for v in rng.integers(6, 120, 2))
        n = int(rng.integers(1, 14))
        pts = np.stack([rng.integers(0, w, n), rng.integers(0, h, n)], 1)
        if i % 4 == 1 and n > 2:
            pts[1] = pts[0]  # a repeated point
        if i % 4 == 2 and n > 3:
            pts[2] = pts[1] + (pts[1] - pts[0])  # collinear
            pts[2] = np.clip(pts[2], 0, [w - 1, h - 1])
        out.append((h, w, pts.astype(np.int32)))
    pts = face.extend_keypoints(synthetic.face_landmarks(rng, 64, 60, 60, mouth_open=0.0))
    for polys in face.PART_POLYGONS:
        out.append((128, 128, pts[[i for p in polys for i in p]].astype(np.int32)))
    return out


def test_fill_poly_matches_cv2():
    rng = np.random.default_rng(0)
    for h, w, pts in _polygons(rng, 400):
        want = np.zeros((h, w), np.uint8)
        cv2.fillPoly(want, pts=[pts], color=5)
        got = raster.fill_poly(np.zeros((h, w), np.uint8), pts, 5)
        np.testing.assert_array_equal(got, want, err_msg=f"{h}x{w} {pts.tolist()}")


@pytest.mark.parametrize("pts", [
    [[3, 22], [10, -11], [35, 4]],  # an edge whose clipped ends share a row
    [[43, 7], [-1, 72], [4, 28], [22, -23], [41, 15], [-15, 74], [-19, -17]],
])
def test_fill_poly_takes_the_clipped_x_of_an_edge_on_one_row(pts):
    """An edge that crosses the image and whose clipped ends fall on one
    row: cv2 takes their x with the rows of the ends as given (its
    right-hand column filled on the rows the polygon covers there)."""
    pts = np.array(pts, np.int32)
    h, w = (7, 7) if len(pts) == 3 else (47, 17)
    want = np.zeros((h, w), np.uint8)
    cv2.fillPoly(want, pts=[pts], color=1)
    np.testing.assert_array_equal(raster.fill_poly(np.zeros((h, w), np.uint8), pts, 1), want)


def test_fill_poly_outside_the_image_differs_only_on_its_border():
    """With vertices outside the image the port equals cv2 pixel for pixel:
    it differs nowhere, the border included (until the port put an edge
    clipped at the right border just right of the image past its clipped
    ends, it filled 18 of these 853,338 pixels in the last column that cv2
    leaves)."""
    rng = np.random.default_rng(1)
    for _ in range(300):
        h, w = (int(v) for v in rng.integers(6, 100, 2))
        n = int(rng.integers(2, 10))
        pts = np.stack([rng.integers(-30, w + 30, n), rng.integers(-30, h + 30, n)], 1).astype(np.int32)
        want = np.zeros((h, w), np.uint8)
        cv2.fillPoly(want, pts=[pts], color=1)
        got = raster.fill_poly(np.zeros((h, w), np.uint8), pts, 1)
        np.testing.assert_array_equal(got, want, err_msg=f"{h}x{w} {pts.tolist()}")


@pytest.mark.parametrize("hw,pts", [
    ((78, 41), [[43, 60], [20, -9]]),
    ((96, 29), [[55, 30], [44, 121], [21, 57], [-26, 59], [19, 66]]),
    ((42, 85), [[-4, 4], [-4, -27], [107, 40], [89, 57], [77, -8]]),
])
def test_fill_poly_leaves_the_last_column_past_a_right_exit(hw, pts):
    """An edge that leaves the image through its right border fills
    nothing in the last column on the rows past its clipped end, where its
    extrapolated x lies in [w - 1, w - 1/2) (cv2 5.0): those rows' spans
    end at the border."""
    pts = np.array(pts, np.int32)
    want = np.zeros(hw, np.uint8)
    cv2.fillPoly(want, pts=[pts], color=1)
    np.testing.assert_array_equal(raster.fill_poly(np.zeros(hw, np.uint8), pts, 1), want)


@pytest.mark.parametrize("blur", [False, True])
def test_canny_matches_cv2(blur):
    rng = np.random.default_rng(2)
    for _ in range(40):
        h, w = (int(v) for v in rng.integers(8, 90, 2))
        img = rng.integers(0, 256, (h, w)).astype(np.uint8)
        if blur:  # blocks with noise: long edges, weak and strong
            img = cv2.GaussianBlur(img, (5, 5), 1.5)
            img = ((img > 120) * 200 + rng.integers(0, 40, (h, w))).astype(np.uint8)
        np.testing.assert_array_equal(raster.canny(img, 100, 200), cv2.Canny(img, 100, 200))


def test_distance_and_gray_match_cv2_and_pil():
    rng = np.random.default_rng(3)
    for k in range(30):
        chain = np.zeros((int(rng.integers(4, 50)), int(rng.integers(4, 50))), np.uint8)
        for _ in range(k % 4):  # no edge pixel at all on every 4th
            chain[rng.integers(0, chain.shape[0]), rng.integers(0, chain.shape[1])] = 255
        want = cv2.distanceTransform(255 - chain, cv2.DIST_L1, 3)
        got = raster.distance_l1(chain)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    assert raster.distance_l1(np.zeros((3, 3), np.uint8)).max() == np.finfo(np.float32).max
    rgb = rng.integers(0, 256, (31, 47, 3)).astype(np.uint8)
    np.testing.assert_array_equal(raster.rgb_to_gray(rgb),
                                  np.asarray(Image.fromarray(rgb).convert("L")))


def test_face_rasters_match_jax():
    """part_label_map, draw_part_edges and distance_maps of seeded faces,
    one with a closed mouth (its inner-lip chains empty: distance 255)."""
    rng = np.random.default_rng(4)
    for mouth in (0.4, 0.0):
        pts = face.extend_keypoints(synthetic.face_landmarks(rng, 70, 60, 64, mouth_open=mouth))
        size = (140, 120)
        np.testing.assert_array_equal(face.part_label_map(pts, size),
                                      jax_face.part_label_map(pts, size))
        got_e, got_c = face.draw_part_edges(pts, size)
        want_e, want_c = jax_face.draw_part_edges(pts, size)
        np.testing.assert_array_equal(got_e, want_e)
        got_d, want_d = face.distance_maps(got_c), jax_face.distance_maps(want_c)
        for g, w in zip(got_d, want_d):
            np.testing.assert_array_equal(g, w)
        empty = [i for i, c in enumerate(got_c) if not c.any()]
        assert (mouth == 0.0) == bool(empty)
        for i in empty:
            assert (got_d[i] == 255).all()


@pytest.mark.parametrize("drop", [0.0, 0.3])
def test_render_openpose_matches_jax(tmp_path, drop):
    """Seeded people with a joint below the confidence gate, gated face and
    hand edges, and with drop > 0 the limb dropout and the face jitter
    (remove_face_labels) under the same default_rng seed."""
    rng = np.random.default_rng(5)
    people = [synthetic.openpose_person(rng, 40, 5, 80),
              synthetic.openpose_person(rng, 90, 10, 70, conf=0.05)]
    path = tmp_path / "kp.json"
    path.write_text(json.dumps({"people": people}))
    for remove_face, basic in ((False, False), (True, False), (False, True)):
        args = ((128, 96), drop, remove_face, basic)
        want = jax_keypoints.render_openpose(str(path), *args, np.random.default_rng(9))
        got = keypoints.render_openpose(str(path), *args, np.random.default_rng(9))
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            keypoints.render_openpose_people(people, *args, np.random.default_rng(9)), want)
        assert want.max() > 0


# ------------------------------------------------------ datasets, streams


def assert_item_equal(got: dict, want: dict):
    """A port item (NCHW) against a JAX item (NHWC): A and inst exactly, B
    to 1e-6."""
    np.testing.assert_array_equal(got["A"], np.moveaxis(want["A"], -1, -3))
    assert got["A"].dtype == np.float32
    np.testing.assert_allclose(got["B"], np.moveaxis(want["B"], -1, -3), rtol=0, atol=1e-6)
    if want["inst"] is None:
        assert got["inst"] is None
    else:
        np.testing.assert_array_equal(got["inst"], want["inst"])
        assert got["inst"].dtype == np.int32
    assert (got["A_path"], got["seq"]) == (want["A_path"], want["seq"])


@pytest.mark.parametrize("resize_or_crop", ["scaleWidth", "scaleWidth_and_crop"])
def test_face_items_match_jax(tmp_path, resize_or_crop):
    """Items with the random stride, start, crop and flip, at a loadSize
    that resizes (PIL bilinear and bicubic) and at one that keeps the size."""
    write_face_tree(str(tmp_path), n_frames=6)
    for load in (96, 80):
        jopt, popt = both(dataroot=str(tmp_path), dataset_mode="face", label_nc=0, input_nc=15,
                          loadSize=load, fineSize=64, resize_or_crop=resize_or_crop,
                          n_frames_total=3, max_frames_per_gpu=1, max_t_step=2, seed=SEED)
        port = create_dataset(popt)
        assert isinstance(port, face.FaceDataset)
        with jax_globals(SEED):
            want = [jax_create_dataset(jopt)[i] for i in range(4)]
        got = [port[i] for i in range(4)]
        for g, w in zip(got, want):
            assert_item_equal(g, w)
        assert got[0]["A"].shape[1] == 15 and got[0]["inst"].max() >= 5


@pytest.mark.parametrize("mode", ["both", "openpose_only", "densepose_only"])
def test_pose_items_match_jax(tmp_path, mode):
    """Training items (the sequence choice, the dropout, the OpenPose
    jitter from default_rng; the stride from the globals) and the scaled
    crop the pose recipes use, at a size the resize keeps."""
    write_pose_tree(str(tmp_path))
    flags = {"openpose_only": dict(openpose_only=True), "densepose_only": dict(densepose_only=True),
             "both": dict(remove_face_labels=True)}[mode]
    jopt, popt = both(dataroot=str(tmp_path), dataset_mode="pose", label_nc=0, input_nc=6,
                      resize_or_crop="scaleHeight_and_scaledCrop", loadSize=96, fineSize=64,
                      n_frames_total=2, max_frames_per_gpu=1, max_t_step=2, random_drop_prob=0.2,
                      seed=SEED, **flags)
    port = create_dataset(popt)
    assert isinstance(port, pose.PoseDataset)
    with jax_globals(SEED):
        jds = jax_create_dataset(jopt)
        want = [jds[i] for i in range(5)]
    got = [port[i] for i in range(5)]
    for g, w in zip(got, want):
        assert_item_equal(g, w)
    assert {g["seq"] for g in got} == {0, 1}


@pytest.mark.parametrize("mode", ["face", "pose"])
def test_test_streams_match_jax(tmp_path, mode):
    """Every item of the JAX FaceTestStream / PoseTestStream, --start_frame
    on the first sequence; face with random_scale_points."""
    (write_face_tree if mode == "face" else write_pose_tree)(str(tmp_path), phase="test")
    extra = dict(random_scale_points=True, input_nc=15) if mode == "face" else dict(
        input_nc=6, resize_or_crop="scaleHeight", loadSize=96)
    jopt, popt = both(dataroot=str(tmp_path), dataset_mode=mode, label_nc=0, isTrain=False,
                      start_frame=1, seed=SEED, **extra)
    with jax_globals(SEED):
        want = list(jax_create_test_stream(jopt))
    got = list(create_test_stream(popt))
    assert len(got) == len(want) > 4
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        np.testing.assert_array_equal(g["A"], w["A"])
        np.testing.assert_allclose(g["B"], w["B"], rtol=0, atol=1e-6)
        if w["inst"] is None:
            assert g["inst"] is None
        else:
            np.testing.assert_array_equal(g["inst"], w["inst"])
        assert (g["change_seq"], g["path"], g["seq"]) == (w["change_seq"], w["path"], w["seq"])


# ------------------------------------------- the array path, without PIL


@pytest.mark.parametrize("method", ["nearest", "bilinear", "bicubic"])
def test_transform_array_matches_pil(method):
    """At a size the resize keeps, the array path (crop, flip) equals PIL's
    resize + crop + flip bit for bit; at another size it goes through PIL."""
    rng = np.random.default_rng(6)
    arr = rng.integers(0, 256, (64, 96, 3)).astype(np.uint8)
    for roc, load, flip in (("scaleWidth", 96, True), ("scaleWidth_and_crop", 96, False),
                            ("scaleHeight_and_scaledCrop", 64, True), ("scaleWidth", 64, False)):
        opt = Options(resize_or_crop=roc, loadSize=load, fineSize=48)
        params = transforms.get_img_params(opt, (96, 64), random.Random(1),
                                           np.random.RandomState(1))
        params.flip = flip
        for img in (arr, arr[..., 0]):  # RGB and one channel
            want = np.asarray(transforms.apply_transform(Image.fromarray(img), opt, params,
                                                         method))
            np.testing.assert_array_equal(transforms.transform_array(img, opt, params, method),
                                          want)


def test_array_builders_run_without_pil_or_cv2(tmp_path, monkeypatch):
    """build_face_frame and pose_conditioning / pose_image with PIL and cv2
    unimportable, at sizes the resize keeps, against the file readers (the
    PIL path) on the same frames."""
    # a 26-wide face: a 64-square crop box, which a loadSize of 64 keeps
    write_face_tree(str(tmp_path / "face"), phase="test", n_seqs=1, n_frames=2, hw=(96, 96),
                    width=26)
    write_pose_tree(str(tmp_path / "pose"), phase="test", n_seqs=1, n_frames=3, hw=(96, 128))
    fopt = Options(dataroot=str(tmp_path / "face"), dataset_mode="face", isTrain=False,
                   input_nc=15, label_nc=0, loadSize=64)
    popt = Options(dataroot=str(tmp_path / "pose"), dataset_mode="pose", isTrain=False,
                   input_nc=6, label_nc=0, resize_or_crop="scaleHeight", loadSize=96)
    fds, pds = face.FaceDataset(fopt), pose.PoseDataset(popt)
    kp, img = fds.a_paths[0][1], fds.b_paths[0][1]
    points = face.load_keypoints(kp)
    rgb = np.asarray(Image.open(img).convert("RGB"))
    crop_box = face.face_crop_box(points, (96, 96))
    y0, y1, x0, x1 = crop_box
    fparams = transforms.get_img_params(fopt, (x1 - x0, y1 - y0), fds.rng, fds.np_rng)
    want_face = face.read_face_frame(kp, img, fopt, fparams, crop_box)
    pparams = transforms.get_img_params(popt, (128, 96), pds.rng, pds.np_rng)
    pds.gen = np.random.default_rng(0)
    want_pose = (pds.conditioning(0, 1, (128, 96), pparams),
                 pose.pose_image(np.asarray(Image.open(pds.img_paths[0][1]).convert("RGB")),
                                 popt, pparams))
    iuv = np.asarray(Image.open(pds.dp_paths[0][1]).convert("RGB"))
    rgb_p = np.asarray(Image.open(pds.img_paths[0][1]).convert("RGB"))
    with open(pds.op_paths[0][1]) as fh:
        people = json.load(fh)["people"]
    assert transforms.target_size(fopt, fparams) == (x1 - x0, y1 - y0)
    assert transforms.target_size(popt, pparams) == (128, 96)
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    monkeypatch.setitem(sys.modules, "cv2", None)
    got_face = face.build_face_frame(points, rgb, fopt, fparams, crop_box)
    got_pose = (pose.pose_conditioning(iuv, people, (128, 96), popt, pparams,
                                       np.random.default_rng(0)),
                pose.pose_image(rgb_p, popt, pparams))
    for g, w in zip(got_face + got_pose, want_face + want_pose):
        np.testing.assert_array_equal(g, w)
    assert got_face[0].shape == (64, 64, 15) and got_pose[0].shape == (96, 128, 6)


def test_pose_units_match_jax():
    """central_crop, densepose_dropout and PoseNormalizer against JAX's."""
    rng = np.random.default_rng(7)
    iuv = synthetic.densepose_iuv(rng, 64, 96, 48, 2, 60)
    np.testing.assert_array_equal(pose.central_crop(iuv), jax_pose.central_crop(iuv))
    for remove in (False, True):
        got = pose.densepose_dropout(iuv, 0.3, remove, np.random.default_rng(1))
        want = jax_pose.densepose_dropout(iuv, 0.3, remove, np.random.default_rng(1))
        np.testing.assert_array_equal(got, want)
    norm, jnorm = pose.PoseNormalizer(30, 70), jax_pose.PoseNormalizer(30, 70)
    norm.fit(iuv)
    jnorm.fit(iuv)
    np.testing.assert_array_equal(norm(iuv), jnorm(iuv))
