"""The int8 serving path of the port's extractor and CLIs (CPU):
`CoastlineExtractor.quantize` / `from_quantized`, `serve()`, the scene
paths, `cli.predict --int8 / --save-quantized / --quantized` and
`cli.export --quantized-out / --calib-images`, as tests/test_quant.py:168-190,
259-272 drive the JAX package's.

Tolerance: none. Everything here is compared within the port: the saved
artifact serves the masks of the extractor that wrote it, the device scene
path equals the host tiling path, the server equals the direct batch.
"""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from coastline_torch.cli.export import main as export_main
from coastline_torch.cli.predict import main as predict_main
from coastline_torch.data.synthetic import make_scene
from coastline_torch.infer import deploy, quant
from coastline_torch.infer.extract import CoastlineExtractor
from coastline_torch.models.registry import create_model
from coastline_torch.utils import torch_import as ti

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def scene_png(tmp_path_factory):
    d = tmp_path_factory.mktemp("img")
    img, _, _ = make_scene(np.random.default_rng(0), 64)
    Image.fromarray(img).save(d / "scene.png")
    return d / "scene.png", img


def test_extractor_quantize_mode(scene_png, tmp_path):
    """quantize() keeps the whole artifact pipeline working on the int8 path."""
    path, img = scene_png
    ex = CoastlineExtractor(image_size=64, device="cpu")
    float_fn = ex._predict_fn
    assert ex.quantize(np.stack([img])) is ex and ex._predict_fn is not float_fn
    assert ex.quantized.arch == "unet" and ex.quantized.device.type == "cpu"
    res = ex.extract_coastline_from_image(str(path), str(tmp_path))
    assert res is not None and res["water_mask"].shape == (64, 64)
    assert (tmp_path / "scene_water_mask.png").exists()
    masks = ex.predict_masks_batch(np.stack([img, img]))
    assert masks.shape == (2, 64, 64) and set(np.unique(masks)) <= {0, 1}
    np.testing.assert_array_equal(masks[0], masks[1])


def test_server_on_quantized_extractor():
    ex = CoastlineExtractor(image_size=64, device="cpu")
    rng = np.random.default_rng(1)
    images = [rng.integers(0, 255, (64, 64, 3), dtype=np.uint8) for _ in range(4)]
    ex.quantize(np.stack(images))
    direct = ex.predict_masks_batch(np.stack(images))
    with ex.serve(batch_size=4) as srv:
        masks = srv.predict_many(images)
    for i in range(4):
        np.testing.assert_array_equal(masks[i], direct[i])


def test_from_quantized_serves_the_quantized_masks(tmp_path):
    """The saved artifact serves quantize()'s masks bit for bit, through the
    batch, the server, the device scene path (equal to the host tiling
    path, band included) and with TTA."""
    npz = str(tmp_path / "q.npz")
    ex = CoastlineExtractor(image_size=32, device="cpu").quantize(save_to=npz)
    served = CoastlineExtractor.from_quantized(npz, image_size=32, device="cpu")
    assert served.model is None and served.quantized.arch == "unet"
    images = np.random.default_rng(2).integers(0, 256, (3, 32, 32, 3), dtype=np.uint8)
    np.testing.assert_array_equal(ex.predict_masks_batch(images),
                                  served.predict_masks_batch(images))
    scene = np.random.default_rng(3).integers(0, 256, (70, 90, 3), dtype=np.uint8)
    mask, band = served.predict_scene(scene, batch=4, with_band=5)
    host_mask, host_band = served.predict_scene(scene, batch=4, with_band=5,
                                                device_pipeline=False)
    np.testing.assert_array_equal(mask, host_mask)
    np.testing.assert_array_equal(band, host_band)
    np.testing.assert_array_equal(mask, ex.predict_scene(scene, batch=4))
    tta = CoastlineExtractor.from_quantized(npz, image_size=32, tta=True, device="cpu")
    got = tta.predict_masks_batch(images)
    assert got.shape == (3, 32, 32) and set(np.unique(got)) <= {0, 1}


@pytest.mark.parametrize("arch,size,want", [("UNet", 32, 21), ("Robust UNet", 32, 38),
                                            ("SegNet", 32, 18)])
def test_int8_conv_calls_a_forward(monkeypatch, arch, size, want):
    """The convs the default policy puts on the int8 path: the UNet's
    dc0.c2, two in each of dc1..dc8 and the four transposed convs (21); the
    Robust U-Net's rb0.c2, three in each projecting block, two in rb4, the
    four dilated branches, four transposed convs and the gates' g and x
    down to 64 channels (38); SegNet's 18 convs past its RGB stem."""
    key = quant.quant_arch_for(arch)
    sd = create_model(arch, **({"n_classes": 2} if key == "unet" else {})).state_dict()
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((1, size, size, 3))
                         .astype(np.float32))
    qm = quant.QuantizedModel.from_state_dict(sd, x, batch_size=1, arch=key, device="cpu")
    calls = []
    real = quant.int8_conv

    def counting(*args, **kw):
        calls.append(args[0].shape)
        return real(*args, **kw)

    monkeypatch.setattr(quant, "int8_conv", counting)
    out = qm(x)
    assert len(calls) == want and torch.isfinite(out).all()


def test_predict_cli_int8_argument_errors(scene_png, tmp_path):
    path, _ = scene_png
    base = [str(path), "--random-weights", "--image-size", "64", "--device", "cpu"]
    with pytest.raises(SystemExit) as e:
        predict_main(base + ["--save-quantized", str(tmp_path / "q.npz")])
    assert e.value.code == 2
    with pytest.raises(SystemExit) as e:
        predict_main(base + ["--int8", "--save-quantized", str(tmp_path / "q.npz"),
                             "--quantized", str(tmp_path / "q.npz")])
    assert e.value.code == 2


def test_predict_cli_int8_then_quantized(scene_png, tmp_path):
    """--int8 --save-quantized writes the artifact; --quantized on a --batch
    directory serves it with no checkpoint, the same masks."""
    path, img = scene_png
    npz = str(tmp_path / "q.npz")
    common = ["--image-size", "64", "--device", "cpu", "--dilation", "5"]
    assert predict_main([str(path), "--random-weights", "--int8", "--save-quantized", npz,
                         "--output", str(tmp_path / "a"), *common]) == 0
    assert os.path.exists(npz) and (tmp_path / "a" / "scene_water_mask.png").exists()
    batch = tmp_path / "batch"
    batch.mkdir()
    Image.fromarray(img).save(batch / "scene.png")
    assert predict_main([str(batch), "--batch", "--quantized", npz, "--output",
                         str(tmp_path / "b"), *common]) == 0
    a, b = (np.asarray(Image.open(tmp_path / d / "scene_water_mask.png")) for d in "ab")
    np.testing.assert_array_equal(a, b)


def _checkpoint_dir(root, arch):
    """A save directory whose best checkpoint holds `arch`'s seeded init."""
    key = quant.quant_arch_for(arch)
    sd = create_model(arch, **({"n_classes": 2} if key == "unet" else {})).state_dict()
    os.makedirs(os.path.join(root, "best"))
    torch.save(sd, os.path.join(root, "best", "model.pth"))
    return str(root), sd


def test_export_cli_quantized_out(tmp_path):
    """--quantized-out with --calib-images: at most eight images, resized
    BILINEAR to --image-size; the artifact equals quantizing the checkpoint
    on those images, and --out is written beside it."""
    ckpt, sd = _checkpoint_dir(tmp_path / "models", "unet")
    calib = tmp_path / "calib"
    calib.mkdir()
    rng = np.random.default_rng(5)
    imgs = [make_scene(rng, 48)[0] for _ in range(9)]
    for i, im in enumerate(imgs):
        Image.fromarray(im).save(calib / f"c{i}.png")
    npz, pth = str(tmp_path / "e.npz"), str(tmp_path / "m.pth")
    assert export_main(["--checkpoint-dir", ckpt, "--quantized-out", npz, "--calib-images",
                        str(calib), "--image-size", "32", "--out", pth, "--device", "cpu"]) == 0
    assert os.path.exists(pth)
    got = deploy.load_quantized(npz, device="cpu")
    used = np.stack([np.asarray(Image.fromarray(im).resize((32, 32), Image.BILINEAR))
                     for im in imgs[:8]])
    want = quant.QuantizedModel.from_state_dict(
        sd, quant.default_calibration(32, used, device="cpu"), arch="unet", device="cpu")
    assert got.arch == "unet" and got.scales == want.scales


@pytest.mark.parametrize("arch,key", [("Robust UNet", "robust_unet"), ("SegNet", "segnet"),
                                      ("WaterNet", "waternet"), ("MSWNet", "mswnet"),
                                      ("HRNet-Water", "hrnet_water"), ("PSPNet", "pspnet"),
                                      ("DeepLabV3+", "deeplabv3p")])
def test_export_cli_quantized_out_other_archs(tmp_path, arch, key):
    """Every ported arch by its registry name: the artifact is written and
    loads in the port and in the JAX package."""
    from coastline.infer import deploy as jdeploy

    ckpt, _ = _checkpoint_dir(tmp_path / "models", arch)
    npz = str(tmp_path / "e.npz")
    assert export_main(["--checkpoint-dir", ckpt, "--arch", arch, "--quantized-out", npz,
                        "--image-size", "32", "--device", "cpu"]) == 0
    assert deploy.load_quantized(npz, device="cpu").arch == key
    assert jdeploy.load_quantized(npz).arch == key


@pytest.mark.parametrize("arch", ["YOLO-SEG", "Fast-SCNN", "ENet", "SegFormer-Lite",
                                  "not_a_model"])
def test_export_cli_refuses_an_unported_arch(tmp_path, capsys, arch):
    """No registry architecture is refused any more: the last four ported
    export at 64^2 (exit 0; the artifact loads in the port and in the JAX
    package). A name outside the registry still exits 2, naming the twelve,
    before any checkpoint IO; no output path is a usage error."""
    from coastline.infer import deploy as jdeploy

    npz = str(tmp_path / "q.npz")
    key = quant.quant_arch_for(arch)
    if key is None:
        rc = export_main(["--checkpoint-dir", str(tmp_path), "--arch", arch,
                          "--quantized-out", npz, "--device", "cpu"])
        err = capsys.readouterr().err
        assert rc == 2 and all(a in err for a in sorted(quant.ARCHS)) and len(quant.ARCHS) == 12
        with pytest.raises(SystemExit):
            export_main(["--checkpoint-dir", str(tmp_path), "--device", "cpu"])
        return
    ckpt, _ = _checkpoint_dir(tmp_path / "models", arch)
    assert export_main(["--checkpoint-dir", ckpt, "--arch", arch, "--quantized-out", npz,
                        "--image-size", "64", "--device", "cpu"]) == 0
    assert deploy.load_quantized(npz, device="cpu").arch == key
    assert jdeploy.load_quantized(npz).arch == key
