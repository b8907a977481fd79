"""Optional Tkinter GUI for coastline extraction (counterpart of
`coastline/cli/gui.py`).

The reference's `CoastlineGUI` + `ZoomableImageCanvas`
(its `predict_coastline.py:34-253,848-1544`): model auto-load,
single, multi and folder selection, an input queue with the reference's
list management (reorder, remove, clear, :1201-1277), background-thread
processing with a progress bar, a tabbed result viewer with wheel-zoom and
drag-pan canvases, a per-image result browser with prev/next navigation
(:1279-1307), clear-results and batch save. All compute lives in
`coastline_torch.infer.extract.CoastlineExtractor` on the chosen device
(`--device`, the card unless `cpu`). Results pass from the worker thread
to the Tk main loop through a thread-safe queue; `ResultStore`,
`ImageQueue`, `drain_queue` and the worker's body `process_images` hold
that protocol without tkinter, so it runs headless (tests, the chip smoke).

The Run action is disabled until the model finishes loading.

Headless environments: `python -m coastline_torch.cli.predict` is the
primary interface; tkinter, Pillow's `ImageTk` and the extractor are
imported inside `main` only.
"""

import os
import queue
import sys
import threading
import traceback


class ResultStore:
    """Ordered store of processed images for the result browser.

    Failed extractions (result None) are recorded so the browser shows
    every attempted image, but `saveable()` returns only successes.
    """

    def __init__(self):
        self._entries = []  # (path, result-or-None)

    def add(self, path, result):
        self._entries.append((path, result))
        return len(self._entries) - 1

    def __len__(self):
        return len(self._entries)

    def get(self, index):
        return self._entries[index]

    def labels(self):
        return [
            f"{os.path.basename(p)}{'' if r is not None else '  (failed)'}"
            for p, r in self._entries
        ]

    def saveable(self):
        return [r for _, r in self._entries if r is not None]

    def clear(self):
        self._entries.clear()

    def prev_index(self, current):
        """Previous browsable index (clamped), reference prev_image
        (`predict_coastline.py:1279-1288`). With no selection, Prev lands
        on the LAST result (and Next on the first) — stepping from an
        imaginary cursor would make the end entries unreachable."""
        if not self._entries:
            return None
        if current is None:
            return len(self._entries) - 1
        return max(0, current - 1)

    def next_index(self, current):
        """Next browsable index (clamped), reference next_image
        (`predict_coastline.py:1290-1299`)."""
        if not self._entries:
            return None
        if current is None:
            return 0
        return min(len(self._entries) - 1, current + 1)


class ImageQueue:
    """Ordered input-image list with the reference GUI's list-management
    operations (`predict_coastline.py:1201-1277`): append/replace
    selections, reorder (move up/down), remove one, clear. Tkinter-free
    so the manipulation logic is testable headless."""

    def __init__(self):
        self._paths = []

    @property
    def paths(self):
        return list(self._paths)

    def __len__(self):
        return len(self._paths)

    def set(self, paths):
        self._paths = list(paths)

    def add(self, paths):
        # de-dup like the reference's select handlers (:1158-1199)
        for p in paths:
            if p not in self._paths:
                self._paths.append(p)

    def move_up(self, index):
        """Swap with the previous entry; returns the new index."""
        if index is None or index <= 0 or index >= len(self._paths):
            return index
        self._paths[index - 1], self._paths[index] = (
            self._paths[index], self._paths[index - 1])
        return index - 1

    def move_down(self, index):
        if index is None or index < 0 or index >= len(self._paths) - 1:
            return index
        self._paths[index + 1], self._paths[index] = (
            self._paths[index], self._paths[index + 1])
        return index + 1

    def remove(self, index):
        if index is not None and 0 <= index < len(self._paths):
            self._paths.pop(index)

    def clear(self):
        self._paths.clear()

    def labels(self):
        return [os.path.basename(p) for p in self._paths]


def drain_queue(q, store, *, on_status=None, on_result=None, on_ready=None,
                on_done=None):
    """Drain the worker->UI queue, applying the GUI message protocol.

    Messages: ("status", text) | ("ready", None) | ("result", (i, path,
    result)) | ("done", None). Results are appended to `store`; callbacks
    receive UI-ready payloads. Returns the number of messages handled.
    Pure (no tkinter) so the protocol is testable headless.
    """
    n = 0
    try:
        while True:
            kind, payload = q.get_nowait()
            n += 1
            if kind == "status" and on_status:
                on_status(payload)
            elif kind == "ready" and on_ready:
                on_ready()
            elif kind == "result":
                i, p, result = payload
                idx = store.add(p, result)
                if on_result:
                    on_result(i, idx, p, result)
            elif kind == "done" and on_done:
                on_done()
    except queue.Empty:
        pass
    return n


def process_images(extractor, paths, q, dilation):
    """The GUI worker's body: extract each image of `paths` with
    `extractor` (band width `dilation`) and put ("result", (i, path,
    result-or-None)) on `q` for each, then ("done", None). A failed image
    gives None and the worker goes on to the next."""
    for i, p in enumerate(paths):
        try:
            result = extractor.extract_coastline_from_image(p, None, dilation)
        except Exception:  # the worker thread must keep going: report, record a failure
            traceback.print_exc()
            result = None
        q.put(("result", (i, p, result)))
    q.put(("done", None))


def main(argv=None):
    try:
        import tkinter as tk
        from tkinter import filedialog, messagebox, ttk
    except ImportError:
        print("tkinter unavailable — use `python -m coastline_torch.cli.predict` instead")
        return 1

    from PIL import Image, ImageTk

    from coastline_torch.infer.extract import CoastlineExtractor

    class ZoomCanvas(tk.Canvas):
        """Wheel-zoom (0.1-5x), drag-pan, double-click-reset image canvas."""

        def __init__(self, master, **kw):
            super().__init__(master, bg="#202020", **kw)
            self._img = None
            self._tk_img = None
            self._scale = 1.0
            self._off = [0, 0]
            self.bind("<MouseWheel>", self._wheel)
            self.bind("<Button-4>", lambda e: self._zoom(1.1, e))
            self.bind("<Button-5>", lambda e: self._zoom(1 / 1.1, e))
            self.bind("<ButtonPress-1>", self._start)
            self.bind("<B1-Motion>", self._drag)
            self.bind("<Double-Button-1>", lambda e: self.fit())

        def show(self, pil_image):
            self._img = pil_image
            self.fit()

        def fit(self):
            if self._img is None:
                return
            w = max(self.winfo_width(), 64)
            h = max(self.winfo_height(), 64)
            self._scale = min(w / self._img.width, h / self._img.height, 5.0)
            self._off = [0, 0]
            self._render()

        def _zoom(self, factor, _event=None):
            self._scale = min(5.0, max(0.1, self._scale * factor))
            self._render()

        def _wheel(self, e):
            self._zoom(1.1 if e.delta > 0 else 1 / 1.1, e)

        def _start(self, e):
            self._anchor = (e.x, e.y)

        def _drag(self, e):
            self._off[0] += e.x - self._anchor[0]
            self._off[1] += e.y - self._anchor[1]
            self._anchor = (e.x, e.y)
            self._render()

        def _render(self):
            if self._img is None:
                return
            size = (
                max(1, int(self._img.width * self._scale)),
                max(1, int(self._img.height * self._scale)),
            )
            self._tk_img = ImageTk.PhotoImage(self._img.resize(size))
            self.delete("all")
            self.create_image(
                self.winfo_width() // 2 + self._off[0],
                self.winfo_height() // 2 + self._off[1],
                image=self._tk_img,
            )

    class App:
        def __init__(self, root, int8: bool = False, quantized: str = None,
                     device: str = "cuda"):
            self.root = root
            self.int8 = int8
            self.quantized = quantized  # serving .npz (infer/deploy.py)
            self.device = device
            root.title("coastline — coastline extraction")
            root.geometry("1100x750")
            self.queue = queue.Queue()
            self.images = ImageQueue()
            self.store = ResultStore()
            self.extractor = None  # set by the loader thread; Run gated on it

            bar = ttk.Frame(root)
            bar.pack(fill="x", padx=6, pady=4)
            ttk.Button(bar, text="Images…", command=self.pick_images).pack(side="left")
            ttk.Button(bar, text="Folder…", command=self.pick_folder).pack(side="left")
            self.run_btn = ttk.Button(bar, text="Run", command=self.run,
                                      state="disabled")
            self.run_btn.pack(side="left", padx=8)
            ttk.Button(bar, text="Save all…", command=self.save_all).pack(side="left")
            ttk.Button(bar, text="Clear results",
                       command=self.clear_results).pack(side="left", padx=4)
            self.dilation = tk.IntVar(value=20)  # GUI default (reference :870)
            ttk.Label(bar, text="dilation").pack(side="left", padx=(12, 2))
            ttk.Spinbox(bar, from_=1, to=60, textvariable=self.dilation,
                        width=4).pack(side="left")
            self.status = tk.StringVar(value="loading model…")
            ttk.Label(root, textvariable=self.status).pack(fill="x", padx=6)
            self.progress = ttk.Progressbar(root)
            self.progress.pack(fill="x", padx=6)

            body = ttk.Frame(root)
            body.pack(fill="both", expand=True, padx=6, pady=4)
            left = ttk.Frame(body)
            left.pack(side="left", fill="y")
            # input queue with the reference's list management
            # (predict_coastline.py:1201-1277)
            ttk.Label(left, text="Images").pack(anchor="w")
            self.queue_box = tk.Listbox(left, width=32, height=8)
            self.queue_box.pack(fill="x")
            qbar = ttk.Frame(left)
            qbar.pack(fill="x")
            for text, cmd in (("↑", self.queue_up), ("↓", self.queue_down),
                              ("✕", self.queue_remove),
                              ("Clear", self.queue_clear)):
                ttk.Button(qbar, text=text, width=5 if text == "Clear" else 2,
                           command=cmd).pack(side="left")
            # result browser: every processed image stays selectable
            # (reference predict_coastline.py:848-1544)
            ttk.Label(left, text="Results").pack(anchor="w")
            self.listbox = tk.Listbox(left, width=32)
            self.listbox.pack(fill="y", expand=True)
            self.listbox.bind("<<ListboxSelect>>", self._on_select)
            nav = ttk.Frame(left)
            nav.pack(fill="x")
            ttk.Button(nav, text="◀ Prev",
                       command=lambda: self._nav(-1)).pack(side="left")
            self.nav_label = ttk.Label(nav, text="0/0")
            self.nav_label.pack(side="left", expand=True)
            ttk.Button(nav, text="Next ▶",
                       command=lambda: self._nav(+1)).pack(side="right")

            tabs = ttk.Notebook(body)
            tabs.pack(side="left", fill="both", expand=True)
            self.canvases = {}
            for name in ("Input", "Water mask", "Coastline band", "Overlay"):
                c = ZoomCanvas(tabs)
                tabs.add(c, text=name)
                self.canvases[name] = c

            threading.Thread(target=self._load_model, daemon=True).start()
            root.after(100, self._poll)

        def _load_model(self):
            try:
                if self.quantized:
                    extractor = CoastlineExtractor.from_quantized(
                        self.quantized, device=self.device)
                else:
                    ckpt = "./models"
                    extractor = (
                        CoastlineExtractor(checkpoint_dir=ckpt, device=self.device)
                        if os.path.isdir(os.path.join(ckpt, "best"))
                        else CoastlineExtractor(device=self.device)
                    )
                    if self.int8:
                        self.queue.put(("status", "quantizing to int8..."))
                        extractor.quantize()
                self.extractor = extractor
                self.queue.put(("ready", None))
                self.queue.put(("status", "model ready"))
            except Exception as e:  # the loader thread reports to the UI
                traceback.print_exc()
                self.queue.put(("status", f"model load failed: {e}"))

        def pick_images(self):
            picked = list(
                filedialog.askopenfilenames(
                    filetypes=[("images", "*.png *.jpg *.jpeg *.tif *.tiff")]
                )
            )
            self.images.add(picked)
            self._refresh_queue()

        def pick_folder(self):
            folder = filedialog.askdirectory()
            if folder:
                exts = (".png", ".jpg", ".jpeg", ".tif", ".tiff")
                self.images.add([
                    os.path.join(folder, f)
                    for f in sorted(os.listdir(folder))
                    if f.lower().endswith(exts)
                ])
                self._refresh_queue()

        def _refresh_queue(self, select=None):
            self.queue_box.delete(0, "end")
            for label in self.images.labels():
                self.queue_box.insert("end", label)
            if select is not None and len(self.images):
                self.queue_box.selection_set(select)
            self.status.set(f"{len(self.images)} image(s) queued")

        def _queue_sel(self):
            sel = self.queue_box.curselection()
            return sel[0] if sel else None

        def queue_up(self):
            self._refresh_queue(self.images.move_up(self._queue_sel()))

        def queue_down(self):
            self._refresh_queue(self.images.move_down(self._queue_sel()))

        def queue_remove(self):
            self.images.remove(self._queue_sel())
            self._refresh_queue()

        def queue_clear(self):
            self.images.clear()
            self._refresh_queue()

        def run(self):
            if self.extractor is None:
                messagebox.showinfo("coastline", "model is still loading")
                return
            if not len(self.images):
                messagebox.showinfo("coastline", "select images first")
                return
            self.clear_results()
            self.progress.configure(maximum=len(self.images), value=0)
            # one batch at a time: re-enabled by the worker's "done" message
            self.run_btn.configure(state="disabled")
            # Tk variables are read on the main loop's thread, not the worker's
            threading.Thread(target=self._worker,
                             args=(self.images.paths, self.dilation.get()),
                             daemon=True).start()

        def _worker(self, paths, dilation):
            process_images(self.extractor, paths, self.queue, dilation)

        def _poll(self):
            drain_queue(
                self.queue,
                self.store,
                on_status=self.status.set,
                on_ready=lambda: self.run_btn.configure(state="normal"),
                on_result=self._on_result,
                on_done=self._on_done,
            )
            self.root.after(100, self._poll)

        def _on_done(self):
            self.status.set(f"done — {len(self.store.saveable())} succeeded")
            self.run_btn.configure(state="normal")

        def _on_result(self, i, idx, path, result):
            self.progress.configure(value=i + 1)
            self.status.set(f"processed {i + 1}/{self.progress['maximum']}")
            self.listbox.insert("end", self.store.labels()[idx])
            if result is not None:
                self._select_result(idx)

        def _select_result(self, idx):
            self.listbox.selection_clear(0, "end")
            self.listbox.selection_set(idx)
            self.nav_label.configure(text=f"{idx + 1}/{len(self.store)}")
            path, result = self.store.get(idx)
            if result is not None:
                self._show(path, result)

        def _on_select(self, _event=None):
            sel = self.listbox.curselection()
            if sel:
                self._select_result(sel[0])

        def _nav(self, step):
            sel = self.listbox.curselection()
            cur = sel[0] if sel else None
            idx = (self.store.next_index(cur) if step > 0
                   else self.store.prev_index(cur))
            if idx is not None:
                self._select_result(idx)

        def clear_results(self):
            self.store.clear()
            self.listbox.delete(0, "end")
            self.nav_label.configure(text="0/0")
            self.progress.configure(value=0)

        def _show(self, path, result):
            import numpy as np

            img = self.extractor._load_image(path)
            self.canvases["Input"].show(img)
            self.canvases["Water mask"].show(
                Image.fromarray(result["water_mask"] * 255)
            )
            self.canvases["Coastline band"].show(
                Image.fromarray(result["coastline_mask"] * 255)
            )
            overlay = np.asarray(img).copy()
            overlay[result["coastline_mask"] > 0] = (255, 0, 0)
            self.canvases["Overlay"].show(Image.fromarray(overlay))

        def save_all(self):
            results = self.store.saveable()
            if not results:
                return
            out = filedialog.askdirectory()
            if out:
                for r in results:
                    self.extractor.save_extraction_result(r, out)
                self.status.set(f"saved {len(results)} result set(s) to {out}")

    import argparse

    ap = argparse.ArgumentParser(
        prog="coastline-gui",
        description="Coastline extraction GUI (reference "
                    "predict_coastline.py:848-1544 equivalent)")
    ap.add_argument("--int8", action="store_true",
                    help="quantize the loaded model to int8 before serving")
    ap.add_argument("--quantized", metavar="NPZ", default=None,
                    help="serve directly from a save_quantized .npz")
    ap.add_argument("--device", default="cuda",
                    help="torch device; without a card only 'cpu' runs")
    args = ap.parse_args(argv if argv is not None else sys.argv[1:])

    root = tk.Tk()
    App(root, int8=args.int8, quantized=args.quantized, device=args.device)
    root.mainloop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
