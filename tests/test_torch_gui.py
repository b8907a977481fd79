"""The port's GUI without a display (CPU): `tests/test_gui.py`'s cases on
`coastline_torch.cli.gui`'s queue protocol, result store and input queue;
the worker's body `process_images` with a CPU extractor; `main` without
tkinter; and an import that loads no tkinter."""

import json
import os
import queue
import subprocess
import sys

import numpy as np
import torch
from PIL import Image

from coastline_torch.cli import gui
from coastline_torch.cli.gui import ImageQueue, ResultStore, drain_queue, process_images
from coastline_torch.infer.extract import CoastlineExtractor
from coastline_torch.infer.morphology import coastline_band

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _mk_result(tag):
    return {"water_mask": tag, "coastline_mask": tag}


def test_drain_queue_routes_messages_and_fills_store():
    q = queue.Queue()
    store = ResultStore()
    seen = {"status": [], "ready": 0, "results": [], "done": 0}

    q.put(("status", "loading model…"))
    q.put(("ready", None))
    q.put(("result", (0, "/a/one.png", _mk_result("r0"))))
    q.put(("result", (1, "/a/two.png", None)))  # failed extraction
    q.put(("result", (2, "/a/three.png", _mk_result("r2"))))
    q.put(("done", None))

    n = drain_queue(
        q, store,
        on_status=seen["status"].append,
        on_ready=lambda: seen.__setitem__("ready", seen["ready"] + 1),
        on_result=lambda i, idx, p, r: seen["results"].append((i, idx, p)),
        on_done=lambda: seen.__setitem__("done", seen["done"] + 1),
    )

    assert n == 6
    assert seen["status"] == ["loading model…"]
    assert seen["ready"] == 1
    assert seen["done"] == 1
    # the store keeps every attempted image in order, the failure too
    assert len(store) == 3
    assert seen["results"] == [(0, 0, "/a/one.png"), (1, 1, "/a/two.png"),
                               (2, 2, "/a/three.png")]


def test_result_store_selection_and_labels():
    store = ResultStore()
    store.add("/data/alpha.png", _mk_result("a"))
    store.add("/data/beta.png", None)
    store.add("/data/gamma.png", _mk_result("g"))

    labels = store.labels()
    assert labels[0] == "alpha.png"
    assert labels[1] == "beta.png  (failed)"
    assert labels[2] == "gamma.png"

    path, result = store.get(0)
    assert path == "/data/alpha.png" and result["water_mask"] == "a"
    path, result = store.get(2)
    assert result["coastline_mask"] == "g"

    assert [r["water_mask"] for r in store.saveable()] == ["a", "g"]

    store.clear()
    assert len(store) == 0 and store.labels() == []


def test_drain_queue_empty_is_noop():
    q = queue.Queue()
    store = ResultStore()
    assert drain_queue(q, store) == 0
    assert len(store) == 0


def test_image_queue_list_management():
    iq = ImageQueue()
    iq.add(["/d/a.png", "/d/b.png"])
    iq.add(["/d/b.png", "/d/c.png"])  # duplicate b is dropped
    assert iq.paths == ["/d/a.png", "/d/b.png", "/d/c.png"]
    assert iq.labels() == ["a.png", "b.png", "c.png"]

    assert iq.move_up(2) == 1  # c above b
    assert iq.paths == ["/d/a.png", "/d/c.png", "/d/b.png"]
    assert iq.move_up(0) == 0  # clamped at top
    assert iq.move_down(2) == 2  # clamped at bottom
    assert iq.move_down(None) is None  # no selection is a no-op
    assert iq.move_down(0) == 1
    assert iq.paths == ["/d/c.png", "/d/a.png", "/d/b.png"]

    iq.remove(1)
    assert iq.paths == ["/d/c.png", "/d/b.png"]
    iq.remove(None)  # no selection is a no-op
    assert len(iq) == 2
    iq.set(["/d/z.png"])
    assert iq.paths == ["/d/z.png"]
    iq.clear()
    assert len(iq) == 0 and iq.labels() == []


def test_result_store_prev_next_navigation():
    store = ResultStore()
    assert store.prev_index(None) is None
    assert store.next_index(None) is None
    for i, p in enumerate(["/r/0.png", "/r/1.png", "/r/2.png"]):
        store.add(p, _mk_result(str(i)))

    assert store.next_index(None) == 0
    assert store.prev_index(None) == 2
    assert store.next_index(0) == 1 and store.next_index(1) == 2
    assert store.next_index(2) == 2
    assert store.prev_index(2) == 1 and store.prev_index(1) == 0
    assert store.prev_index(0) == 0


def test_process_images_feeds_the_store(tmp_path):
    """Two 64² tiles and an unreadable path through the worker's body with a
    CPU extractor, drained as the Tk loop drains them, then saved."""
    yy, xx = np.mgrid[0:64, 0:64]
    paths = []
    for i in range(2):
        img = np.zeros((64, 64, 3), np.uint8)
        img[yy > 30 + 8 * np.sin(xx / 9.0 + i)] = (20, 60, 160)
        img[yy <= 30 + 8 * np.sin(xx / 9.0 + i)] = (200, 180, 120)
        paths.append(str(tmp_path / f"tile{i}.png"))
        Image.fromarray(img).save(paths[-1])
    paths.insert(1, str(tmp_path / "missing.png"))
    ex = CoastlineExtractor(image_size=64, device="cpu")
    q = queue.Queue()
    process_images(ex, paths, q, 5)
    store, done = ResultStore(), []
    assert drain_queue(q, store, on_done=lambda: done.append(1)) == 4
    assert done == [1] and len(store) == 3
    assert store.labels()[1] == "missing.png  (failed)"
    results = store.saveable()
    assert [r["image_path"] for r in results] == [paths[0], paths[2]]
    for r in results:
        band = coastline_band(r["water_mask"], 5, device="cpu").numpy()
        np.testing.assert_array_equal(r["coastline_mask"], band)
        assert r["water_mask"].shape == (64, 64) and r["dilation_size"] == 5
        ex.save_extraction_result(r, str(tmp_path / "out"))
        base = os.path.splitext(os.path.basename(r["image_path"]))[0]
        with open(tmp_path / "out" / f"{base}_coastlines.json") as f:
            assert json.load(f)["coastline_count"] == r["coastline_count"]
        assert (tmp_path / "out" / f"{base}_coastline_mask.png").exists()


def test_main_without_tkinter_returns_1(monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "tkinter", None)  # makes `import tkinter` raise
    assert gui.main([]) == 1
    assert "coastline_torch.cli.predict" in capsys.readouterr().out


def test_import_loads_no_tkinter():
    probe = ("import sys, coastline_torch.cli.gui; "
             "print(sorted(m for m in sys.modules if m.split('.')[0] in "
             "('tkinter', '_tkinter', 'jax', 'coastline')))")
    out = subprocess.run([sys.executable, "-c", probe], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
