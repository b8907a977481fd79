"""`coastline_torch/parallel/mesh.py`'s numpy helpers against the JAX
package's on the same inputs (they are copied line for line and must give
the same arrays), `make_mesh`'s size checks, and (two gloo processes)
`process_local_slab` and a sample-sharded epoch built from the slabs, the
counterpart of `tests/test_multiprocess.py`."""

import numpy as np
import pytest
import torch

import torch_parallel_workers as workers
from coastline.parallel import mesh as jax_mesh
from coastline_torch.parallel import mesh
from coastline_torch.parallel.launch import check_devices, run

torch.set_num_threads(1)


def _data(n, seed=0, size=2):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 255, (n, size, size, 3)).astype(np.uint8),
            rng.integers(0, 2, (n, size, size)).astype(np.uint8))


@pytest.mark.parametrize("n,k", [(14, 4), (16, 4), (3, 8), (1, 2), (5, 5), (7, 3)])
def test_pad_for_sharding_matches_jax(n, k):
    images, masks = _data(n)
    got, ref = mesh.pad_for_sharding(images, masks, k), jax_mesh.pad_for_sharding(images, masks, k)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="empty"):
        mesh.pad_for_sharding(images[:0], masks[:0], k)


@pytest.mark.parametrize("n_real,n_stored,batch,k,shuffle", [
    (14, 16, 8, 4, True), (14, 16, 8, 4, False), (16, 16, 4, 2, True),
    (3, 8, 8, 8, False),  # five shards hold only padding
    (9, 12, 6, 3, True), (5, 8, 4, 4, True), (1, 4, 4, 4, False)])
def test_sharded_batch_indices_match_jax(n_real, n_stored, batch, k, shuffle):
    got = mesh.sharded_batch_indices(n_real, n_stored, batch, k, shuffle=shuffle,
                                     rng=np.random.default_rng(3))
    ref = jax_mesh.sharded_batch_indices(n_real, n_stored, batch, k, shuffle=shuffle,
                                         rng=np.random.default_rng(3))
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    local = mesh.localize_aligned_indices(got[0], n_stored, k)
    np.testing.assert_array_equal(local, jax_mesh.localize_aligned_indices(ref[0], n_stored, k))
    flat = got[0].reshape(-1)[got[1].reshape(-1) > 0]
    assert sorted(flat.tolist()) == list(range(n_real))


@pytest.mark.parametrize("args", [(14, 16, 6, 4), (14, 15, 8, 4)])
def test_sharded_batch_indices_refuse_as_jax(args):
    for fn in (mesh.sharded_batch_indices, jax_mesh.sharded_batch_indices):
        with pytest.raises(ValueError):
            fn(*args, shuffle=False, rng=np.random.default_rng(0))


@pytest.mark.parametrize("idx", [np.full(8, 15), np.arange(8)[::-1], np.arange(8) + 2])
def test_misaligned_indices_raise(idx):
    for fn in (mesh.localize_aligned_indices, jax_mesh.localize_aligned_indices):
        with pytest.raises(ValueError, match="not shard-aligned"):
            fn(idx, 16, 8)


def test_process_local_slab_one_process_matches_jax():
    """Without a process group the port is one process, as JAX here."""
    images, masks = _data(14)
    for a, b in zip(mesh.process_local_slab(images, masks, 4),
                    jax_mesh.process_local_slab(images, masks, 4)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n,kw,message", [
    (4, dict(model=3), "4 devices not divisible by space=1 x dcn=1 x model=3"),
    (8, dict(space=3), "8 devices not divisible by space=3 x dcn=1 x model=1"),
    (6, dict(dcn=4), "6 devices not divisible by space=1 x dcn=4 x model=1")])
def test_mesh_sizes_refused_with_jax_message(n, kw, message):
    with pytest.raises(ValueError, match=message):
        mesh.make_mesh(n, **kw)
    with pytest.raises(ValueError, match=message):
        jax_mesh.make_mesh(n, **kw)


def test_mesh_shapes_and_space_axis():
    assert mesh.mesh_shape(8) == ((8,), ("data",))
    assert mesh.mesh_shape(8, dcn=2) == ((2, 4), ("dcn", "data"))
    assert mesh.mesh_shape(8, model=2) == ((4, 2), ("data", "model"))
    assert mesh.mesh_shape(8, dcn=2, model=2) == ((2, 2, 2), ("dcn", "data", "model"))
    assert mesh.mesh_shape(8, space=2) == ((4, 2), ("data", "space"))
    with pytest.raises(RuntimeError, match="process group"):
        mesh.make_mesh(8, space=2)
    with pytest.raises(RuntimeError, match="process group"):
        mesh.make_mesh(2)


@pytest.mark.parametrize("nprocs,device,backend,error", [
    (2, "cpu", "nccl", "gloo"), (0, "cpu", "gloo", "at least one"),
    (2, "cuda", "nccl", "CUDA"), (2, "cuda:0", "gloo", "CUDA")])
def test_launcher_refuses_what_cannot_run(nprocs, device, backend, error):
    """No quiet fallback: a CUDA request without a card raises here."""
    with pytest.raises((ValueError, RuntimeError), match=error):
        check_devices(nprocs, device, backend)


def test_two_process_slabs_match_one_process():
    """(g) two processes each pass only their slab of the padded order: the
    slabs tile the one-process padded arrays, the shard built from a slab
    equals the one built from the global arrays, and so does its epoch;
    `paths` is padded with the wrap rule on that branch too (JAX leaves it
    unpadded there, `coastline/parallel/mesh.py:316`)."""
    images, masks = _data(7, seed=4, size=32)
    paths = [f"img_{i}.png" for i in range(7)]
    out = run(workers.slab_checks, 2, device="cpu", args=(images, masks, 2, paths))
    one = mesh.pad_for_sharding(images, masks, 2)
    np.testing.assert_array_equal(np.concatenate([r["slab"][0] for r in out]), one[0])
    np.testing.assert_array_equal(np.concatenate([r["slab"][1] for r in out]), one[1])
    padded = paths + ["img_0.png"]
    for r in out:
        assert r["slab"][2] == 7 and r["len"] == 7
        assert r["paths"] == r["global_paths"] == padded
        assert r["equal_images"]
        assert r["losses"][0] == r["losses"][1] and np.isfinite(r["losses"][0])
    assert out[0]["losses"] == out[1]["losses"]
