"""The port's checkpoints (``repro_torch/ckpt/checkpoint.py``): the cases of
``tests/test_checkpoint.py`` for the port's tensors (exact round trips with
their dtypes, the async writer's lifecycle, the snapshot taken before the
state is updated in place, the refusals and the crash guarantees), and files
passed both ways between the port and ``repro.ckpt.checkpoint``."""
import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.ckpt.checkpoint as ckpt_mod
from repro.ckpt import checkpoint as ref_ckpt
from repro.optim import optimizer as ref_opt
from repro_torch.ckpt.checkpoint import AsyncCheckpointer, load_pytree, save_pytree
from repro_torch.optim.optimizer import OptState, init_opt_state


def _train_state():
    """A train state as the launcher saves it: nested dicts, the optimizer's
    NamedTuple, a list, and f32, int32 and bf16 leaves."""
    g = torch.Generator().manual_seed(0)
    params = {"embed": torch.randn((3, 4), generator=g),
              "layers": {"wq": torch.randn((2, 4, 4), generator=g).to(torch.bfloat16),
                         "scale": torch.ones((4,))},
              "ids": torch.arange(6, dtype=torch.int32).reshape(2, 3)}
    opt = init_opt_state(params)
    opt.mu["embed"].fill_(0.25)
    return {"params": params, "opt": OptState(torch.tensor(7, dtype=torch.int32), opt.mu, opt.nu),
            "history": [torch.tensor(1.5), torch.tensor(0.9)]}


def _leaves(tree):
    return dict(ckpt_mod._walk(tree))


def _assert_same(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert list(la) == list(lb)
    for key in la:
        x, y = la[key], lb[key]
        assert x.dtype == y.dtype and x.shape == y.shape, key
        assert torch.equal(x, y), key


def test_save_load_roundtrip_exact(tmp_path):
    tree = _train_state()
    p = str(tmp_path / "ck.npz")
    save_pytree(p, tree, {"step": 7})
    out = load_pytree(p, tree)
    _assert_same(out, tree)
    assert isinstance(out["opt"], OptState) and isinstance(out["history"], list)
    assert out["params"]["layers"]["wq"].dtype == torch.bfloat16 and out["params"]["ids"].dtype == torch.int32
    with open(p + ".json") as f:
        assert json.load(f) == {"step": 7}
    with np.load(p) as z:
        assert sorted(z.files) == sorted(_leaves(tree))
        assert {"history/0", "history/1", "opt/.step", "opt/.mu/embed", "opt/.nu/layers/wq"} <= set(z.files)
        assert z["params/layers/wq"].dtype == np.dtype("V2")  # bf16 as the reference's files hold it


def test_roundtrip_from_numpy_leaves(tmp_path):
    tree = {"w": np.arange(6, dtype=np.float32).reshape(2, 3), "b": np.zeros((3,), np.int32)}
    p = str(tmp_path / "ck.npz")
    save_pytree(p, tree)
    out = load_pytree(p, tree)
    np.testing.assert_array_equal(out["w"], tree["w"])
    np.testing.assert_array_equal(out["b"], tree["b"])
    assert out["b"].dtype == np.int32


def test_async_checkpointer_lifecycle(tmp_path):
    tree = _train_state()
    d = str(tmp_path)
    ck = AsyncCheckpointer(d, keep=3)
    assert ck.latest_path() is None
    for step in (10, 20, 30, 40, 50):
        stamped = dict(tree, history=[torch.tensor(float(step)), torch.tensor(float(step))])
        ck.save(step, stamped, {"step": step})
    ck.close()
    # gc kept exactly `keep` newest checkpoints
    npzs = sorted(f for f in os.listdir(d) if f.endswith(".npz"))
    assert npzs == ["step_00000030.npz", "step_00000040.npz", "step_00000050.npz"]
    # latest points at the newest, and restores the matching content
    assert ck.latest_path().endswith("step_00000050.npz")
    out = load_pytree(ck.latest_path(), tree)
    assert float(out["history"][0]) == 50.0
    with open(ck.latest_path() + ".json") as f:
        assert json.load(f)["step"] == 50
    # one timing a save, each written
    assert [t["step"] for t in ck.timings] == [10, 20, 30, 40, 50]
    nbytes = sum(t.numel() * t.element_size() for t in _leaves(tree).values())
    assert all(t["bytes"] == nbytes and t["snapshot_s"] >= 0 and t["write_ended"] >= t["write_started"]
               for t in ck.timings)


def test_async_save_snapshots_before_mutation(tmp_path):
    """save() copies every leaf before it returns: the port updates its
    parameters and moments in place, and a CPU tensor's numpy() aliases it."""
    w = torch.ones((4,))
    state = init_opt_state({"w": w})
    ck = AsyncCheckpointer(str(tmp_path))
    ck.save(1, {"params": {"w": w}, "opt": state})
    w.mul_(0.0)  # the next step updates the live state in place
    state.mu["w"].add_(3.0)
    ck.close()
    out = load_pytree(ck.latest_path(), {"params": {"w": w}, "opt": state})
    assert torch.equal(out["params"]["w"], torch.ones((4,)))
    assert torch.equal(out["opt"].mu["w"], torch.zeros((4,)))


def test_load_rejects_shape_mismatch(tmp_path):
    p = str(tmp_path / "x.npz")
    save_pytree(p, {"w": torch.ones((2, 2))})
    with pytest.raises(ValueError, match="shape"):
        load_pytree(p, {"w": torch.ones((4,))})


def test_load_rejects_dtype_mismatch(tmp_path):
    p = str(tmp_path / "x.npz")
    save_pytree(p, {"w": torch.ones((2, 2)), "b": torch.ones((2,), dtype=torch.bfloat16)})
    with pytest.raises(ValueError, match="dtype"):
        load_pytree(p, {"w": torch.ones((2, 2), dtype=torch.bfloat16), "b": torch.ones((2,), dtype=torch.bfloat16)})
    with pytest.raises(ValueError, match="dtype"):
        load_pytree(p, {"w": torch.ones((2, 2)), "b": torch.ones((2,))})


def test_load_missing_key_raises(tmp_path):
    p = str(tmp_path / "x.npz")
    save_pytree(p, {"w": torch.ones((2, 2))})
    with pytest.raises(KeyError):
        load_pytree(p, {"w": torch.ones((2, 2)), "extra": torch.ones((1,))})


def test_wait_blocks_until_write_durable(monkeypatch, tmp_path):
    """With a slow writer, wait() does not return before the bytes and the
    latest pointer are on disk."""
    real_save = ckpt_mod.save_pytree

    def slow_save(path, tree, meta=None):
        time.sleep(0.3)
        real_save(path, tree, meta)

    monkeypatch.setattr(ckpt_mod, "save_pytree", slow_save)
    ck = AsyncCheckpointer(str(tmp_path))
    ck.save(1, {"w": torch.ones((2,))})
    ck.wait()
    p = ck.latest_path()
    assert p is not None and os.path.exists(p)
    ck.close()


def test_save_pytree_crash_leaves_no_partial_npz(monkeypatch, tmp_path):
    def exploding_savez(f, **kw):
        f.write(b"partial garbage")
        raise RuntimeError("disk full")

    monkeypatch.setattr(np, "savez", exploding_savez)
    p = str(tmp_path / "ck.npz")
    with pytest.raises(RuntimeError):
        save_pytree(p, {"w": torch.ones((2,))})
    assert not os.path.exists(p)


def test_save_pytree_leaves_no_tmp_droppings(tmp_path):
    p = str(tmp_path / "ck.npz")
    save_pytree(p, {"w": torch.ones((2,))}, {"step": 1})
    assert sorted(os.listdir(tmp_path)) == ["ck.npz", "ck.npz.json"]


def test_close_with_pending_error_still_stops_worker(monkeypatch, tmp_path):
    def failing_save(path, tree, meta=None):
        raise IOError("no space left on device")

    monkeypatch.setattr(ckpt_mod, "save_pytree", failing_save)
    ck = AsyncCheckpointer(str(tmp_path))
    ck.save(1, {"w": torch.ones((2,))})
    with pytest.raises(IOError):
        ck.close()
    ck._thread.join(timeout=5)
    assert not ck._thread.is_alive()


def test_pending_error_raises_on_the_next_save(monkeypatch, tmp_path):
    def failing_save(path, tree, meta=None):
        raise IOError("no space left on device")

    monkeypatch.setattr(ckpt_mod, "save_pytree", failing_save)
    ck = AsyncCheckpointer(str(tmp_path))
    ck.save(1, {"w": torch.ones((2,))})
    with pytest.raises(IOError):
        ck.wait()
    with pytest.raises(IOError):
        ck.save(2, {"w": torch.ones((2,))})
    with pytest.raises(IOError):
        ck.close()


# -- files passed between the packages ---------------------------------------


def _reference_state():
    """The reference's train state after one AdamW update (moments not 0), with
    a bf16 leaf beside the f32 ones."""
    rng = np.random.default_rng(0)
    params = {"embed": jnp.asarray(rng.standard_normal((5, 4)), jnp.float32),
              "layers": {"wq": jnp.asarray(rng.standard_normal((2, 4, 4)), jnp.bfloat16),
                         "ln1": jnp.ones((2, 4), jnp.float32)}}
    grads = jax.tree.map(lambda p: jnp.full(p.shape, 0.5, p.dtype), params)
    params, opt, _ = ref_opt.adamw_update(ref_opt.OptimizerConfig(), grads, params, ref_opt.init_opt_state(params))
    return {"params": params, "opt": opt}


def _as_port(ref_tree):
    """The reference's tree as the port's tensors, bit for bit (bf16 through its two bytes)."""

    def leaf(x):
        a = np.asarray(x)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
        return torch.from_numpy(a.copy())

    return {"params": jax.tree.map(leaf, ref_tree["params"]),
            "opt": OptState(leaf(ref_tree["opt"].step), jax.tree.map(leaf, ref_tree["opt"].mu),
                            jax.tree.map(leaf, ref_tree["opt"].nu))}


def _bits(x) -> bytes:
    """The raw bytes of a torch tensor, a jax array or a numpy array (bf16 as its two bytes)."""
    if isinstance(x, torch.Tensor):
        return (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy().tobytes()
    return np.asarray(x).tobytes()


def test_a_reference_checkpoint_loads_in_the_port(tmp_path):
    tree = _reference_state()
    p = str(tmp_path / "ref.npz")
    ref_ckpt.save_pytree(p, tree, {"step": 1})
    like = jax.tree.map(torch.zeros_like, _as_port(tree))
    out = load_pytree(p, like)
    want = ref_ckpt._flatten(tree)
    got = _leaves(out)
    assert set(got) == set(want) == set(_leaves(like))
    assert {"opt/.step", "opt/.mu/embed", "opt/.nu/layers/wq", "params/layers/wq"} <= set(got)
    for key, arr in want.items():
        assert tuple(got[key].shape) == arr.shape, key
        assert _bits(got[key]) == _bits(arr), key
    assert out["params"]["layers"]["wq"].dtype == torch.bfloat16 and int(out["opt"].step) == 1


def test_a_port_checkpoint_loads_in_the_reference(tmp_path):
    """Every leaf comes back with its bits; a bf16 leaf comes back as the raw
    ``|V2`` bytes the reference's own file holds for it (the reference's
    ``load_pytree`` does not restore bf16 from ``like``: shown, not repaired)."""
    ref_tree = _reference_state()
    port_tree = _as_port(ref_tree)
    p = str(tmp_path / "port.npz")
    save_pytree(p, port_tree, {"step": 1})
    out = ref_ckpt.load_pytree(p, ref_tree)
    assert isinstance(out["opt"], ref_opt.OptState)
    for (key, got), (_, want) in zip(ref_ckpt._flatten(out).items(), ref_ckpt._flatten(ref_tree).items()):
        assert got.shape == want.shape and _bits(got) == _bits(want), key
    # the reference's fault: its own bf16 leaf also loads as |V2, byte for byte the port's
    q = str(tmp_path / "ref.npz")
    ref_ckpt.save_pytree(q, ref_tree)
    ref_wq = ref_ckpt.load_pytree(q, ref_tree)["params"]["layers"]["wq"]
    port_wq = out["params"]["layers"]["wq"]
    assert ref_wq.dtype == port_wq.dtype == np.dtype("V2")
    assert ref_wq.tobytes() == port_wq.tobytes() == _bits(port_tree["params"]["layers"]["wq"])
