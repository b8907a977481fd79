"""Coastline extraction (counterpart of `coastline/infer/extract.py`).

`CoastlineExtractor` holds the production 2-class UNet on one device and
turns images into water masks (normalize -> forward -> argmax, with the
optional D4 test-time-augmentation ensemble), then the coastline band
(`infer/morphology.py`, the dilation kernel on the card) and the shoreline
polylines (`infer/contours.py`, on the host). Its entry points:

  * `predict_masks_batch` / `serve()`: (N, H, W, 3) uint8 batches at the
    model's size, and the micro-batching server in front of them;
  * `predict_mask` / `extract_coastline_from_image` / `extract_batch`: image
    files (PNG, JPEG, GeoTIFF through `data/geotiff.py`) resized to the
    model's size and the masks restored to the native size, with the
    artifact set `save_extraction_result` writes;
  * `predict_scene` / `extract_scene` / `extract_scenes`: native-resolution
    scenes tiled through the model (`infer/scene.py` on the device, or the
    host tiling path `data/tiling.py`), the per-year workflow.

`quantize()` switches every one of them to the int8 PTQ forward
(`infer/quant.py`), and `from_quantized` serves a saved `.npz` artifact
(`infer/deploy.py`) with no float checkpoint. `predict_scene(mesh=)`
deals a scene's chunks of tiles over a mesh's ranks (`infer/scene.py`).
"""

import json
import os
from datetime import datetime
from typing import List, Mapping, Optional

import numpy as np
import torch

from coastline_torch.data.pipeline import normalize_u8
from coastline_torch.infer.contours import extract_contours
from coastline_torch.infer.morphology import coastline_band
from coastline_torch.infer.server import BatchedPredictor
from coastline_torch.models.unet import UNet
from coastline_torch.utils.device import resolve_device
from coastline_torch.utils.torch_import import detect_reference_architecture, unet_state_dict


def _make_predict_fn(model, tta: bool = False):
    """(N, H, W, 3) uint8 tensor on the model's device -> (N, H, W) uint8
    masks. The NHWC input is normalized in float32 and handed to the model
    as an NCHW view, i.e. already channels_last.

    With `tta=True` the class probabilities (float32) are averaged over the
    identity, H-flip, W-flip and 180-degree terms and, for square inputs,
    the same four on the transposed image, each inverted before averaging,
    in the JAX package's order."""

    @torch.inference_mode()
    def predict(x_u8):
        x = normalize_u8(x_u8).permute(0, 3, 1, 2)
        if not tta:
            return model(x).argmax(dim=1).to(torch.uint8)

        def probs_of(xi):
            return torch.softmax(model(xi).float(), dim=1)

        acc = probs_of(x)
        for dims in ((2,), (3,), (2, 3)):
            acc = acc + torch.flip(probs_of(torch.flip(x, dims)), dims)
        if x.shape[2] == x.shape[3]:
            xt = x.transpose(2, 3)
            acc = acc + probs_of(xt).transpose(2, 3)
            for dims in ((2,), (3,), (2, 3)):
                acc = acc + torch.flip(probs_of(torch.flip(xt, dims)), dims).transpose(2, 3)
        return acc.argmax(dim=1).to(torch.uint8)

    return predict


def _download_async(*tensors: torch.Tensor):
    """Queue copies of `tensors` to the host behind the work that makes them;
    returns a function that waits for them and gives numpy arrays.

    On CUDA the copies go into pinned buffers without blocking, so work the
    caller queues afterwards (the next chunk or scene) runs while the host
    waits for these, and does not delay them. On the CPU the arrays are
    the tensors' own."""
    if tensors[0].device.type != "cuda":
        return lambda: [t.numpy() for t in tensors]
    hosts = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in tensors]
    for host, t in zip(hosts, tensors):
        host.copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record()

    def wait():
        done.synchronize()
        return [host.numpy() for host in hosts]

    return wait


class CoastlineExtractor:
    """The 2-class UNet behind the extraction entry points.

    Weights come from `variables` (a JAX-package UNet tree as numpy, through
    the weight bridge), `torch_checkpoint` (a reference UNet `.pth`, loaded with
    strict=True) or `checkpoint_dir` (a save directory of the port's
    trainer, whose `best/model.pth` is read); with none, the UNet keeps its
    seeded random init. `dtype` is the compute dtype (torch.float32 or
    torch.bfloat16)."""

    def __init__(self, checkpoint_dir: Optional[str] = None,
                 variables: Optional[Mapping] = None,
                 torch_checkpoint: Optional[str] = None,
                 dtype: torch.dtype = torch.float32, image_size: int = 512,
                 tta: bool = False, device="cuda"):
        self.device = resolve_device(device)
        self.image_size = image_size
        self.tta = tta
        model = UNet(n_classes=2, dtype=dtype)
        if variables is not None:
            model.load_state_dict(unet_state_dict(variables), strict=True)
        elif torch_checkpoint is not None:
            sd = torch.load(torch_checkpoint, map_location="cpu", weights_only=True)
            arch = detect_reference_architecture(sd)
            if arch != "UNet":
                raise ValueError(
                    f"{torch_checkpoint} is a {arch!r} checkpoint; the "
                    "extractor's 2-class argmax pipeline expects the "
                    "reference UNet artifact. Load it into "
                    f"coastline_torch.models.create_model({arch!r}) directly.")
            model.load_state_dict(sd, strict=True)
            print(f"loaded PyTorch checkpoint {torch_checkpoint}")
        elif checkpoint_dir is not None:
            from coastline_torch.train.checkpoint import CheckpointManager

            # what WaterSegmentationTrainer.load_best reads
            sd = CheckpointManager(checkpoint_dir).restore_best()
            if sd is None:
                raise FileNotFoundError(f"no best checkpoint under {checkpoint_dir}")
            model.load_state_dict(sd, strict=True)
            print(f"loaded model from {checkpoint_dir}")
        else:
            print("WARNING: no checkpoint provided — using random weights")
        self.model = model.to(self.device).eval()
        self.quantized = None
        self._predict_fn = _make_predict_fn(self.model, tta=tta)
        self._scene_cache = {}

    # ---------------------------------------------------------------- int8
    def quantize(self, calib_images_u8: Optional[np.ndarray] = None, batch_size: int = 2,
                 save_to: Optional[str] = None):
        """Switch every predict path to the int8 PTQ forward (`infer/quant.py`).

        `calib_images_u8` is (N, image_size, image_size, 3) uint8
        representative data (default: the synthetic coastal scenes of
        `quant.default_calibration`). `save_to` also writes the quantized
        weights and scales as one .npz (`infer/deploy.py`) that
        `from_quantized` serves without the float checkpoint or calibration
        data. Returns self."""
        from coastline_torch.infer.quant import QuantizedModel, default_calibration

        calib = default_calibration(self.image_size, calib_images_u8, device=self.device)
        qm = QuantizedModel.from_state_dict(self.model.state_dict(), calib,
                                            batch_size=batch_size, arch="unet",
                                            device=self.device)
        if save_to is not None:
            from coastline_torch.infer.deploy import save_quantized

            save_quantized(save_to, qm)
            print(f"saved quantized serving artifact: {save_to}")
        self._wire_quantized(qm)
        return self

    def _wire_quantized(self, qm) -> None:
        """Route the predict function through an int8 `QuantizedModel`: the
        model callable of `_make_predict_fn` takes and returns NCHW views of
        the quantized forward's NHWC tensors."""
        self.quantized = qm
        self._predict_fn = _make_predict_fn(
            lambda x: qm(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2), tta=self.tta)
        self._scene_cache = {}  # scene functions built around the float forward

    @classmethod
    def from_quantized(cls, npz_path: str, image_size: int = 512, tta: bool = False,
                       device="cuda"):
        """Serve straight from a `save_quantized` .npz (written by this
        package or the JAX one): no float checkpoint, weights tree or
        calibration data. The artifact must hold the 2-class UNet."""
        from coastline_torch.infer.deploy import load_quantized

        dev = resolve_device(device)
        qm = load_quantized(npz_path, device=dev)
        if qm.arch != "unet":
            raise ValueError(f"{npz_path} holds a {qm.arch!r} quantized model; the extractor's "
                             "2-class argmax pipeline expects arch 'unet'")
        ex = cls.__new__(cls)
        ex.device, ex.image_size, ex.tta = dev, image_size, tta
        ex.model = None  # no float model: the int8 forward is the server
        ex._wire_quantized(qm)
        print(f"loaded quantized serving artifact {npz_path}")
        return ex

    # ------------------------------------------------------------------ io
    def _load_image_meta(self, image_path: str):
        """An RGB PIL image and its raster metadata (geotransform and
        projection for a georeferenced TIFF, else None). A TIFF that fails
        to load gives a black 512^2 image, as the JAX package does."""
        from PIL import Image

        if image_path.lower().endswith((".tif", ".tiff")):
            from coastline_torch.data.geotiff import load_tif_enhanced

            try:
                rgb, meta = load_tif_enhanced(image_path)
                return Image.fromarray(rgb), meta
            except Exception as e:
                print(f"TIF load failed {image_path}: {e}")
                return Image.new("RGB", (512, 512), (0, 0, 0)), None
        return Image.open(image_path).convert("RGB"), None

    def _load_image(self, image_path: str):
        return self._load_image_meta(image_path)[0]

    # ------------------------------------------------------------- predict
    def predict_masks_batch_async(self, images_u8) -> torch.Tensor:
        """(N, H, W, 3) uint8 (numpy or tensor) -> (N, H, W) uint8 masks as a
        tensor on the device; on CUDA the work is queued, not waited for."""
        x = images_u8
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.ascontiguousarray(x))
        if x.ndim != 4 or x.shape[-1] != 3 or x.dtype != torch.uint8:
            raise ValueError(f"expected uint8 (N, H, W, 3), got {x.dtype} {tuple(x.shape)}")
        return self._predict_fn(x.to(self.device))

    def predict_masks_batch(self, images_u8) -> np.ndarray:
        """Batched (N, H, W, 3) uint8 -> (N, H, W) uint8 numpy masks."""
        return self.predict_masks_batch_async(images_u8).cpu().numpy()

    def predict_mask(self, image) -> np.ndarray:
        """A PIL image -> (H, W) uint8 mask at its native size: BILINEAR
        resize to the model's size, predict, NEAREST resize back."""
        from PIL import Image

        s = self.image_size
        x = np.array(image.resize((s, s), Image.BILINEAR), np.uint8)[None]
        mask = self.predict_masks_batch(x)[0]
        return np.array(Image.fromarray(mask).resize(image.size, Image.NEAREST), np.uint8)

    def predict_scene(self, scene_u8: np.ndarray, batch: int = 8,
                      overlap: Optional[int] = None, device_pipeline: bool = True,
                      with_band: Optional[int] = None, mesh=None):
        """(H, W, 3) uint8 scene -> (H, W) uint8 water mask at native
        resolution through the tile pipeline, and with `with_band=<dilation
        size>` also its coastline band, as numpy arrays.

        The default seam overlap is image_size // 8 (64 px at 512).
        `device_pipeline=True` runs `infer/scene.py`: one upload, tiles cut
        on the device, the band from the stitched mask on the device, one
        download of each result. `False` takes the host tiling path; the
        two are bit-identical.

        `mesh=` (`parallel.mesh.make_mesh`, called on every rank with the
        same scene) deals the chunks of `batch` tiles over the mesh's data
        groups (`infer/scene.py` says why whole chunks); every rank gets the
        whole mask, bit-identical to one device's. The host tiling path
        ignores `mesh`."""
        if overlap is None:
            overlap = self.image_size // 8
        if device_pipeline:
            out = self._predict_scene_device(scene_u8, batch=batch, overlap=overlap,
                                             with_band=with_band, mesh=mesh)
            if with_band is not None:
                return tuple(t.cpu().numpy() for t in out)
            return out.cpu().numpy()

        from coastline_torch.data.tiling import stitch_tiles, tile_scene

        tiles, grid = tile_scene(scene_u8, self.image_size, overlap)
        outs = []
        for i in range(0, tiles.shape[0], batch):
            chunk = tiles[i:i + batch]
            pad = batch - chunk.shape[0]
            if pad:  # every forward sees the one batch shape
                chunk = np.concatenate([chunk, np.zeros((pad,) + chunk.shape[1:], chunk.dtype)])
            masks = self.predict_masks_batch(chunk)
            outs.append(masks[:batch - pad])
        mask = stitch_tiles(np.concatenate(outs), grid)
        if with_band is not None:
            return mask, coastline_band(mask, with_band, device=self.device).cpu().numpy()
        return mask

    def _predict_scene_device(self, scene_u8: np.ndarray, batch: int = 8,
                              overlap: Optional[int] = None,
                              with_band: Optional[int] = None, mesh=None):
        """Queue the device scene pipeline and return its DEVICE tensors (the
        mask, or (mask, band)) without waiting for them: the caller can
        prepare the next scene while the card works on this one. On CUDA the
        scene is uploaded from pinned memory without blocking the host.
        Scene functions are cached by geometry and by the mesh's axes, ranks
        and this rank's device: two meshes of one shape over other ranks
        never share one."""
        if overlap is None:
            overlap = self.image_size // 8
        from coastline_torch.infer.scene import build_scene_fn

        h, w, c = scene_u8.shape
        mesh_key = None if mesh is None else (
            tuple(zip(mesh.mesh_dim_names, mesh.mesh.shape)),
            tuple(mesh.mesh.flatten().tolist()), str(self.device))
        key = (self._predict_fn, h, w, c, self.image_size, overlap, batch, with_band, mesh_key)
        cache = self.__dict__.setdefault("_scene_cache", {})
        fn = cache.get(key)
        if fn is None:
            fn = cache[key] = build_scene_fn(
                self._predict_fn, h, w, c, self.image_size, overlap, batch,
                band_dilation=with_band, mesh=mesh)
        scene = torch.from_numpy(np.ascontiguousarray(scene_u8))
        if self.device.type == "cuda":
            scene = scene.pin_memory()
        return fn(scene.to(self.device, non_blocking=True))

    # ------------------------------------------------------------- extract
    def _result(self, path, image, meta, mask, dilation_size, band=None) -> dict:
        """The result dict of one image: its mask at native size, the band
        (taken here unless given) and the traced polylines."""
        if band is None:
            band = coastline_band(mask, dilation_size, device=self.device).cpu().numpy()
        coastlines = extract_contours(band)
        result = {"image_path": path, "image_size": list(image.size), "water_mask": mask,
                  "coastline_mask": band, "coastlines": coastlines,
                  "coastline_count": len(coastlines), "dilation_size": dilation_size,
                  "extraction_time": str(datetime.now())}
        if meta and meta.get("geo_transform"):
            result["geo_transform"] = list(meta["geo_transform"])
            result["projection"] = meta.get("projection")
        return result

    def extract_coastline_from_image(self, image_path: str, output_dir: Optional[str] = None,
                                     dilation_size: int = 5) -> Optional[dict]:
        """One image file -> its result dict (artifacts written when
        `output_dir` is given), or None if anything fails."""
        try:
            image, meta = self._load_image_meta(image_path)
            result = self._result(image_path, image, meta, self.predict_mask(image),
                                  dilation_size)
            if output_dir:
                self.save_extraction_result(result, output_dir, image)
            return result
        except Exception as e:
            print(f"extraction failed for {image_path}: {e}")
            return None

    def save_extraction_result(self, result: dict, output_dir: str, image=None):
        """Write `{base}_water_mask.png`, `{base}_coastline_mask.png` and
        `{base}_coastlines.json`, `{base}_coastlines.geojson` when the result
        holds a geotransform, and the analysis figure (a failed figure is
        printed and skipped)."""
        from PIL import Image

        os.makedirs(output_dir, exist_ok=True)
        base = os.path.splitext(os.path.basename(result["image_path"]))[0]
        Image.fromarray(result["water_mask"] * 255).save(
            os.path.join(output_dir, f"{base}_water_mask.png"))
        Image.fromarray(result["coastline_mask"] * 255).save(
            os.path.join(output_dir, f"{base}_coastline_mask.png"))
        payload = {"image_path": result["image_path"], "image_size": result["image_size"],
                   "coastlines": result["coastlines"],
                   "coastline_count": result["coastline_count"],
                   "dilation_size": result.get("dilation_size", 5),
                   "extraction_time": result["extraction_time"]}
        with open(os.path.join(output_dir, f"{base}_coastlines.json"), "w",
                  encoding="utf-8") as f:
            json.dump(payload, f, indent=2, ensure_ascii=False)
        if result.get("geo_transform"):
            from coastline_torch.infer.geojson import coastlines_to_geojson

            gj = coastlines_to_geojson(
                result["coastlines"], result["geo_transform"],
                projection=result.get("projection"),
                properties={"image_path": result["image_path"],
                            "dilation_size": result.get("dilation_size", 5)})
            if gj is not None:
                with open(os.path.join(output_dir, f"{base}_coastlines.geojson"), "w",
                          encoding="utf-8") as f:
                    json.dump(gj, f, indent=2, ensure_ascii=False)
        try:
            from coastline_torch.report.coastsat_fig import create_analysis_figure

            create_analysis_figure(result, output_dir, image)
        except Exception as e:
            print("analysis figure failed:", e)
        print(f"results saved to {output_dir}")

    def serve(self, batch_size: int = 8, max_delay_ms: float = 5.0) -> BatchedPredictor:
        """Micro-batching server over `predict_masks_batch`: concurrent
        callers submit single images, the model sees fixed-shape batches.
        Use as a context manager."""
        return BatchedPredictor(self.predict_masks_batch, batch_size=batch_size,
                                image_size=self.image_size, max_delay_ms=max_delay_ms)

    def extract_batch(self, image_paths: List[str], output_dir: str, dilation_size: int = 5,
                      batch_size: int = 8) -> List[Optional[dict]]:
        """Directory-scale extraction with batched forwards: each chunk of
        `batch_size` files is loaded, resized to the model's size and run
        at the one batch shape, then each mask is restored to its native
        size for the band, contours and artifacts: the per-image path's
        results with fewer forwards.

        Double-buffered: chunk N+1 is queued on the device before chunk N's
        masks are fetched, so the host writes chunk N's artifacts while the
        card runs chunk N+1. A file that fails to load or save gives None; a
        chunk whose forward fails gives None for its files; the run goes on."""
        from PIL import Image

        s = self.image_size
        results: List[Optional[dict]] = [None] * len(image_paths)
        inflight: List[tuple] = []  # (start, paths, images, metas, fetch)

        def finish():
            start, chunk_paths, loaded, metas, fetch = inflight.pop(0)
            try:
                (preds,) = fetch()
            except Exception as e:
                print(f"batched forward failed for chunk at {start}: {e}")
                return
            for j, (p, image) in enumerate(zip(chunk_paths, loaded)):
                if image is None:
                    continue
                try:
                    mask = np.array(Image.fromarray(preds[j]).resize(image.size, Image.NEAREST),
                                    np.uint8)
                    result = self._result(p, image, metas[j], mask, dilation_size)
                    if output_dir:
                        self.save_extraction_result(result, output_dir, image)
                    results[start + j] = result
                except Exception as e:
                    print(f"extraction failed for {p}: {e}")

        for start in range(0, len(image_paths), batch_size):
            chunk_paths = image_paths[start:start + batch_size]
            loaded, metas = [], []
            for p in chunk_paths:
                try:
                    im, meta = self._load_image_meta(p)
                except Exception as e:
                    print(f"load failed for {p}: {e}")
                    im, meta = None, None
                loaded.append(im)
                metas.append(meta)
            arr = np.zeros((batch_size, s, s, 3), np.uint8)
            for j, im in enumerate(loaded):
                if im is not None:
                    arr[j] = np.asarray(im.resize((s, s), Image.BILINEAR), np.uint8)
            try:
                fetch = _download_async(self.predict_masks_batch_async(arr))
                inflight.append((start, chunk_paths, loaded, metas, fetch))
            except Exception as e:
                print(f"batched forward failed for chunk at {start}: {e}")
            while len(inflight) >= 2:
                finish()
        while inflight:
            finish()
        return results

    # ---------------------------------------------------- scene extraction
    def extract_scene(self, image_path: str, output_dir: Optional[str] = None,
                      dilation_size: int = 5, batch: int = 8) -> Optional[dict]:
        """Native-resolution tiled extraction of one scene: the device scene
        pipeline with the band, contours on the host and the single-image
        path's artifact set (no NEAREST restore: the masks are at the
        scene's size). None on failure."""
        return self.extract_scenes([image_path], output_dir, dilation_size=dilation_size,
                                   batch=batch)[0]

    def extract_scenes(self, image_paths: List[str], output_dir: Optional[str] = None,
                       dilation_size: int = 5, batch: int = 8,
                       pipeline_depth: int = 2) -> List[Optional[dict]]:
        """Pipelined multi-scene extraction (the per-year workflow).

        Scene N+1 is loaded, uploaded and queued on the device before scene
        N's mask and band are waited for, so the card predicts N+1 while the
        host traces and writes N. Each scene's results are copied into
        pinned buffers as soon as its work is queued, so that copy does not
        wait for the next scene's work. `pipeline_depth` bounds the scenes
        in flight (2 = double buffering; each holds its padded upload and
        its mask and band on the device). A failed load, dispatch or save
        gives None for that scene and the run goes on. Results in input
        order."""
        results: List[Optional[dict]] = [None] * len(image_paths)
        inflight: List[tuple] = []  # (idx, path, image, meta, fetch)

        def finish():
            idx, path, image, meta, fetch = inflight.pop(0)
            try:
                mask, band = fetch()
                result = self._result(path, image, meta, mask, dilation_size, band=band)
                if output_dir:
                    self.save_extraction_result(result, output_dir, image)
                results[idx] = result
            except Exception as e:
                print(f"extraction failed for {path}: {e}")

        depth = max(1, pipeline_depth)
        for idx, path in enumerate(image_paths):
            try:
                image, meta = self._load_image_meta(path)
                scene = np.array(image, np.uint8)  # writable: torch.from_numpy shares it
                fetch = _download_async(*self._predict_scene_device(scene, batch=batch,
                                                                    with_band=dilation_size))
                inflight.append((idx, path, image, meta, fetch))
            except Exception as e:
                print(f"extraction failed for {path}: {e}")
            while len(inflight) >= depth:
                finish()
        while inflight:
            finish()
        return results
