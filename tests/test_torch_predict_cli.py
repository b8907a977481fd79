"""The port's predict, convert, change and export CLIs vs the JAX package's
(CPU).

Tolerances: water masks >= 99.9% of pixels against JAX (float32 logits
summed in another order flip the argmax only at near ties); conversion
PNGs and metadata, change rates and GeoJSON, and everything compared
within the port: exact.
"""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from coastline.cli.change import main as jax_change_main
from coastline.cli.convert import main as jax_convert_main
from coastline.cli.predict import main as jax_predict_main
from coastline_torch.cli.change import main as change_main
from coastline_torch.cli.convert import main as convert_main
from coastline_torch.cli.export import main as export_main
from coastline_torch.cli.predict import main as predict_main
from coastline_torch.data.synthetic import make_scene, synthetic_device_dataset
from coastline_torch.infer.extract import CoastlineExtractor
from coastline_torch.models.unet import UNet

torch.set_num_threads(1)

GT = [500000.0, 10.0, 0.0, 4000000.0, 0.0, -10.0]


def _write_five_band(path, img, rng):
    bands = [rng.integers(0, 255, img.shape[:2], dtype=np.uint8), img[..., 1], img[..., 2],
             img[..., 1], img[..., 0]]
    frames = [Image.fromarray(b) for b in bands]
    frames[0].save(path, save_all=True, append_images=frames[1:])


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """A PNG, a directory of three images, a 128x192 PNG scene and a
    5-band TIFF scene."""
    d = tmp_path_factory.mktemp("inputs")
    rng = np.random.default_rng(0)
    img, _, _ = make_scene(rng, size=64)
    Image.fromarray(img).save(d / "single.png")
    batch = d / "batch"
    batch.mkdir()
    for i in range(3):
        tile, _, _ = make_scene(rng, size=48 + 8 * i)
        Image.fromarray(tile).save(batch / f"b{i}.png")
    Image.fromarray(np.tile(img, (2, 3, 1))).save(d / "scene.png")
    _write_five_band(str(d / "scene.tif"), np.tile(img, (2, 2, 1)), rng)
    return d


@pytest.fixture(scope="module")
def random_weights_pth(tmp_path_factory):
    """The port's `--random-weights` UNet (its seeded init) as a
    reference-layout .pth, which the JAX CLI takes with --torch-checkpoint."""
    path = str(tmp_path_factory.mktemp("weights") / "unet.pth")
    torch.save(UNet(n_classes=2).state_dict(), path)
    return path


def _outputs(out):
    return sorted(os.listdir(out))


def _masks_agree(a_dir, b_dir):
    names = [n for n in os.listdir(a_dir) if n.endswith("_water_mask.png")]
    assert names
    for name in names:
        a = np.asarray(Image.open(os.path.join(a_dir, name)))
        b = np.asarray(Image.open(os.path.join(b_dir, name)))
        assert a.shape == b.shape and np.mean(a == b) >= 0.999, name


@pytest.mark.parametrize("mode", ["single", "batch", "scene", "tif_scene"])
def test_predict_cli_matches_jax(inputs, random_weights_pth, tmp_path, mode):
    src, flags = {"single": ("single.png", []), "batch": ("batch", ["--batch"]),
                  "scene": ("scene.png", ["--scene"]),
                  "tif_scene": ("scene.tif", ["--scene"])}[mode]
    common = [str(inputs / src), "--image-size", "64", "--dilation", "5", *flags]
    got, ref = str(tmp_path / "port"), str(tmp_path / "jax")
    assert predict_main(common + ["--random-weights", "--device", "cpu", "--output", got]) == 0
    assert jax_predict_main(common + ["--torch-checkpoint", random_weights_pth,
                                      "--output", ref]) == 0
    assert _outputs(got) == _outputs(ref)
    _masks_agree(got, ref)
    for name in _outputs(got):
        if name.endswith("_coastlines.json"):
            a, b = (json.load(open(os.path.join(d, name))) for d in (got, ref))
            assert sorted(a) == sorted(b) and a["image_size"] == b["image_size"]
    if mode == "scene":
        assert np.asarray(Image.open(os.path.join(got, "scene_water_mask.png"))).shape == (128, 192)


@pytest.mark.parametrize("flags", [["--int8"], ["--int8", "--save-quantized", "q.npz"],
                                   ["--quantized", "q.npz"]])
def test_predict_cli_int8_flags_are_not_ported(inputs, tmp_path, flags, capsys):
    """The int8 flags, refused while int8 was not ported (the name is from
    then), now serve: each run exits 0 with its artifacts; --save-quantized
    writes the .npz that --quantized serves with no checkpoint."""
    npz = tmp_path / "q.npz"
    if "--quantized" in flags:
        CoastlineExtractor(image_size=64, device="cpu").quantize(save_to=str(npz))
    flags = [str(npz) if f == "q.npz" else f for f in flags]
    rc = predict_main([str(inputs / "single.png"), "--random-weights", "--image-size", "64",
                       "--device", "cpu", "--output", str(tmp_path / "out"), *flags])
    assert rc == 0 and (tmp_path / "out" / "single_water_mask.png").exists()
    assert npz.exists() == ("--save-quantized" in flags or "--quantized" in flags)
    assert "not ported yet" not in capsys.readouterr().err


def test_predict_cli_missing_checkpoint(inputs, tmp_path, capsys):
    rc = predict_main([str(inputs / "single.png"), "--checkpoint", str(tmp_path / "nope"),
                       "--image-size", "64", "--device", "cpu"])
    assert rc == 1 and "hint" in capsys.readouterr().out


def test_predict_cli_directory_contract(tmp_path):
    """An empty directory exits 1; a directory of scenes with one corrupt
    file writes the good ones and exits 0."""
    assert predict_main([str(tmp_path), "--random-weights", "--device", "cpu"]) == 1
    img, _, _ = make_scene(np.random.default_rng(0), size=32)
    d = tmp_path / "years"
    d.mkdir()
    for year in (2020, 2021):
        Image.fromarray(np.tile(img, (2, 3, 1))).save(d / f"{year}.png")
    (d / "2022.png").write_bytes(b"not a png")
    out = str(tmp_path / "out")
    assert predict_main([str(d), "--batch", "--scene", "--random-weights", "--image-size", "32",
                         "--output", out, "--dilation", "5", "--device", "cpu"]) == 0
    for year in (2020, 2021):
        assert np.asarray(Image.open(os.path.join(out, f"{year}_water_mask.png"))).shape == (64, 96)
    assert not os.path.exists(os.path.join(out, "2022_water_mask.png"))


def test_convert_cli_matches_jax(tmp_path):
    """A 2017-2025 year tree (and a flat directory) converts to JAX's PNGs,
    metadata and summary, apart from timestamps and the output paths."""
    rng = np.random.default_rng(1)
    for year, n in ((2019, 2), (2021, 1)):
        d = tmp_path / "data" / str(year)
        d.mkdir(parents=True)
        for i in range(n):
            img, _, _ = make_scene(rng, size=40)
            _write_five_band(str(d / f"s{year}_{i}.tif"), img, rng)
    flat = tmp_path / "flat"
    flat.mkdir()
    Image.fromarray(rng.integers(0, 255, (20, 30, 3), dtype=np.uint8)).save(flat / "a.tiff")
    for src, n_files in (("data", 3), ("flat", 1)):
        got, ref = tmp_path / f"port_{src}", tmp_path / f"jax_{src}"
        assert convert_main(["--input", str(tmp_path / src), "--output", str(got)]) == 0
        assert jax_convert_main(["--input", str(tmp_path / src), "--output", str(ref)]) == 0
        pngs = sorted(os.listdir(got / "converted"))
        assert pngs == sorted(os.listdir(ref / "converted")) and len(pngs) == n_files
        for name in pngs:
            assert (got / "converted" / name).read_bytes() == (ref / "converted" / name).read_bytes()
            a, b = (json.load(open(d / "metadata" / name.replace(".png", ".json")))
                    for d in (got, ref))
            for m in (a, b):
                del m["conversion_time"], m["png_file"]
            assert a == b
        a, b = (json.load(open(d / "conversion_summary.json")) for d in (got, ref))
        assert a["total_files"] == b["total_files"] == n_files
        assert a["converted_files"] == b["converted_files"] == n_files
    assert convert_main(["--input", str(tmp_path / "none"), "--output", str(tmp_path / "o")]) == 0


def _shore(offset, n=40):
    x = np.arange(0, 400, 10)
    return [[float(v), float(100 + offset + 5 * np.sin(v / 40.0))] for v in x[:n]]


def test_change_cli_matches_jax(tmp_path):
    """Three dated `_coastlines.json` artifacts give JAX's rates, positions
    and transects exactly; the CLI's refusals keep JAX's exit code 2."""
    paths = []
    for year, off in ((2019, 0), (2021, 6), (2024, 14)):
        paths.append(str(tmp_path / f"scene_{year}_coastlines.json"))
        with open(paths[-1], "w") as f:
            json.dump({"coastlines": [_shore(off), [[0, 0]]]}, f)
    got, ref = tmp_path / "port", tmp_path / "jax"
    args = paths + ["--spacing", "40", "--length", "200", "--side", "both"]
    assert change_main(args + ["--output-dir", str(got)]) == 0
    assert jax_change_main(args + ["--output-dir", str(ref)]) == 0
    a, b = (json.load(open(d / "shoreline_change.json")) for d in (got, ref))
    assert a == b and a["n_transects_with_rate"] > 0 and a["units"] == "px"
    assert (got / "shoreline_change.png").exists()
    assert change_main(paths[:1]) == 2
    assert change_main(paths + ["--dates", "2019"]) == 2
    assert change_main(paths[:2] + ["--baseline", "1,2"]) == 2


def test_change_cli_writes_rates_when_the_figure_fails(tmp_path, monkeypatch):
    """Where matplotlib does not import, the rates are written, the failure
    is printed and the CLI exits 0."""
    import coastline_torch.report.change_fig as change_fig

    def no_matplotlib(*a, **k):
        raise ImportError("No module named 'matplotlib'")

    monkeypatch.setattr(change_fig, "plot_shoreline_change", no_matplotlib)
    paths = []
    for year, off in ((2019, 0), (2024, 10)):
        paths.append(str(tmp_path / f"{year}_coastlines.json"))
        with open(paths[-1], "w") as f:
            json.dump({"coastlines": [_shore(off)]}, f)
    out = tmp_path / "out"
    assert change_main(paths + ["--output-dir", str(out)]) == 0
    assert (out / "shoreline_change.json").exists() and not (out / "shoreline_change.png").exists()


def test_geo_extraction_to_change_rates_matches_jax(tmp_path, monkeypatch):
    """Georeferenced extraction (geotransform stubbed into the TIFF intake,
    mask fixed) -> world-space GeoJSON for two dates -> change CLI: the
    port's GeoJSON equals JAX's and the rates are 20 m/yr
    (`tests/test_change.py::test_geo_extraction_to_change_rates_end_to_end`)."""
    from coastline.infer.extract import CoastlineExtractor as JaxExtractor

    port = CoastlineExtractor(image_size=32, device="cpu")
    jax_ex = JaxExtractor.__new__(JaxExtractor)  # only save_extraction_result is used
    outs = {"port": [], "jax": []}
    for year, split in ((2019, 24), (2022, 30)):
        img = np.zeros((64, 64, 3), np.uint8)
        img[:, :split] = 200
        path = str(tmp_path / f"scene_{year}.tif")
        Image.fromarray(img).save(path)
        mask = np.zeros((64, 64), np.uint8)
        for r in range(64):  # jagged: a straight band compresses to a dropped contour
            mask[r, split + (r % 4):] = 1

        def fake_load(self, p, _img=img):
            return Image.fromarray(_img), {"geo_transform": GT, "projection": "EPSG:32630"}

        monkeypatch.setattr(CoastlineExtractor, "_load_image_meta", fake_load)
        monkeypatch.setattr(port, "predict_mask", lambda im, _m=mask: _m)
        out = str(tmp_path / f"port_{year}")
        res = port.extract_coastline_from_image(path, output_dir=out, dilation_size=3)
        assert res is not None and res["geo_transform"] == GT
        outs["port"].append(os.path.join(out, f"scene_{year}_coastlines.geojson"))
        jax_dir = str(tmp_path / f"jax_{year}")
        jax_ex.save_extraction_result(dict(res), jax_dir)
        outs["jax"].append(os.path.join(jax_dir, f"scene_{year}_coastlines.geojson"))
        assert open(outs["port"][-1]).read() == open(outs["jax"][-1]).read()
    baseline = "500275,3999995 500275,3999365"
    rates = {}
    for side, main in (("port", change_main), ("jax", jax_change_main)):
        d = str(tmp_path / f"chg_{side}")
        assert main(outs[side] + ["--baseline", baseline, "--spacing", "100", "--length",
                                  "800", "--output-dir", d]) == 0
        rates[side] = json.load(open(os.path.join(d, "shoreline_change.json")))
    assert rates["port"]["units"] == "m" and rates["port"]["rates"] == rates["jax"]["rates"]
    finite = [r for r in rates["port"]["rates"] if r == r]
    assert len(finite) >= 4 and all(abs(abs(r) - 20.0) < 1e-6 for r in finite)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A port trainer's save directory after one epoch at 32^2."""
    from coastline_torch.train.trainer import TrainerConfig, WaterSegmentationTrainer

    save_dir = str(tmp_path_factory.mktemp("models"))
    cfg = TrainerConfig(epochs=1, batch_size=2, image_size=32, save_dir=save_dir, viz_every=0,
                        augment=False, checkpoint_every=0)
    trainer = WaterSegmentationTrainer(cfg, device="cpu")
    trainer.train(synthetic_device_dataset(4, 32, seed=0, device="cpu"),
                  synthetic_device_dataset(2, 32, seed=1, device="cpu"))
    return save_dir


def test_export_round_trip_serves_the_checkpoint(trained, inputs, tmp_path):
    """`cli.export` writes the best checkpoint as a .pth that loads strictly
    into the UNet with every tensor equal; `checkpoint_dir=` and
    `torch_checkpoint=` of the export serve the same masks, through the
    extractor and through the predict CLI."""
    pth = str(tmp_path / "model.pth")
    assert export_main(["--checkpoint-dir", trained, "--out", pth, "--device", "cpu"]) == 0
    exported = torch.load(pth, map_location="cpu", weights_only=True)
    best = torch.load(os.path.join(trained, "best", "model.pth"), weights_only=True)
    assert exported.keys() == best.keys()
    assert all(torch.equal(exported[k], best[k]) for k in best)
    UNet(n_classes=2).load_state_dict(exported, strict=True)
    images = np.random.default_rng(2).integers(0, 256, (2, 32, 32, 3), dtype=np.uint8)
    a = CoastlineExtractor(checkpoint_dir=trained, image_size=32, device="cpu")
    b = CoastlineExtractor(torch_checkpoint=pth, image_size=32, device="cpu")
    np.testing.assert_array_equal(a.predict_masks_batch(images), b.predict_masks_batch(images))
    outs = []
    for flags in (["--checkpoint", trained], ["--torch-checkpoint", pth]):
        outs.append(str(tmp_path / flags[0].strip("-")))
        assert predict_main([str(inputs / "batch"), "--batch", "--image-size", "32", "--device",
                             "cpu", "--output", outs[-1], *flags]) == 0
    assert _outputs(outs[0]) == _outputs(outs[1])
    for name in _outputs(outs[0]):
        if name.endswith("_mask.png"):
            assert (open(os.path.join(outs[0], name), "rb").read()
                    == open(os.path.join(outs[1], name), "rb").read())


def test_export_refusals(trained, tmp_path, capsys):
    """--quantized-out now writes the int8 artifact (tests/test_torch_int8_cli.py);
    it refuses an arch without an int8 fold: every registry architecture has
    one, so a name outside the registry."""
    assert export_main(["--checkpoint-dir", trained, "--quantized-out", "q.npz", "--arch",
                        "not_a_model", "--device", "cpu"]) == 2
    assert "no int8 fold" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        export_main(["--checkpoint-dir", str(tmp_path), "--out", str(tmp_path / "x.pth"),
                     "--device", "cpu"])
    with pytest.raises(RuntimeError, match="size mismatch|Missing|Unexpected"):
        export_main(["--checkpoint-dir", trained, "--out", str(tmp_path / "y.pth"),
                     "--arch", "SegNet", "--device", "cpu"])
