"""The port's checkpoint layer against the JAX package's.

* The msgpack codec (`repro_torch.checkpoint._msgpack`) against ``msgpack``
  itself: the same bytes from ``packb`` and the same values from
  ``unpackb``, on payloads drawn from a numpy seed at every size boundary
  of the format, on real checkpoint manifests and on WAL record bodies;
  ``np.int64`` is refused by both.
* Mirrors of ``tests/test_train_and_ckpt.py::TestCheckpoint`` and
  ``tests/test_faults.py::TestCorruptCheckpoint`` on tensors.
* Across packages: what ``repro.checkpoint`` writes the port reads and the
  reverse, with equal arrays (bfloat16 bit for bit), equal CRCs and equal
  manifests apart from the write time.

Everything is compared exactly: bytes, bits, CRCs and decoded values.
"""

import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
msgpack = pytest.importorskip("msgpack")

import jax
import jax.numpy as jnp

from repro.checkpoint import ckpt as jckpt
from repro_torch.checkpoint import (CheckpointManager, CorruptCheckpoint,
                                    _msgpack, all_steps, latest_step,
                                    load_arrays, restore_checkpoint,
                                    save_arrays, save_checkpoint)
from repro_torch.checkpoint import ckpt as pckpt

RNG_SEED = 61


def same_value(a, b) -> bool:
    """Equal decoded values, with NaN equal to NaN and -0.0 apart from
    0.0 (msgpack keeps the bits)."""
    if isinstance(a, float) and isinstance(b, float):
        if math.isnan(a) or math.isnan(b):
            return math.isnan(a) and math.isnan(b)
        return a == b and math.copysign(1, a) == math.copysign(1, b)
    if type(a) is not type(b):
        return False
    if isinstance(a, list):
        return len(a) == len(b) and all(map(same_value, a, b))
    if isinstance(a, dict):
        return list(a) == list(b) and all(same_value(a[k], b[k]) for k in a)
    return a == b


def assert_codec_agrees(obj) -> None:
    want = msgpack.packb(obj)
    got = _msgpack.packb(obj)
    assert got == want
    assert same_value(_msgpack.unpackb(want), msgpack.unpackb(want))


def _ints(rng):
    edges = [0, 1, 127, 128, 255, 256, 2**16 - 1, 2**16, 2**32 - 1, 2**32,
             2**63 - 1, 2**64 - 1, -1, -32, -33, -128, -129, -2**15,
             -2**15 - 1, -2**31, -2**31 - 1, -2**63]
    drawn = [int(x) for x in rng.integers(-2**63, 2**63 - 1, 64,
                                          dtype=np.int64)]
    return edges + drawn


def _strs(rng):
    out = []
    for n in (0, 1, 31, 32, 255, 256, 65535, 65536):
        out.append("".join(rng.choice(list("abcxyz"), n)))
    out += ["héllo", "日本語テキスト", "☃" * 11, "é" * 16, "\u0000mixed\U0001F600"]
    return out


def _bins(rng):
    return [rng.integers(0, 256, n, dtype=np.uint8).tobytes()
            for n in (0, 1, 31, 32, 255, 256, 65535, 65536)]


def _containers(rng):
    out = []
    for n in (0, 1, 15, 16, 65535, 65536):
        vals = [int(x) for x in rng.integers(-300, 300, n)]
        out.append(vals)
        out.append(tuple(vals[:3]))
        out.append({f"k{i}": v for i, v in enumerate(vals)})
    return out


def _floats(rng):
    return ([0.0, -0.0, 1.5, -2.25, float("nan"), float("inf"),
             float("-inf"), 5e-324, 1.7976931348623157e308]
            + [float(x) for x in rng.normal(size=32) * 1e6])


def _nested(rng, depth=0):
    kind = rng.integers(0, 8 if depth < 4 else 5)
    if kind == 0:
        return int(rng.integers(-2**40, 2**40))
    if kind == 1:
        return float(rng.normal())
    if kind == 2:
        return "".join(rng.choice(list("ab☃é"), int(rng.integers(0, 40))))
    if kind == 3:
        return [None, True, False][int(rng.integers(0, 3))]
    if kind == 4:
        return rng.integers(0, 256, int(rng.integers(0, 300)),
                            dtype=np.uint8).tobytes()
    if kind in (5, 6):
        return [_nested(rng, depth + 1) for _ in range(int(rng.integers(0, 20)))]
    return {f"f{i}": _nested(rng, depth + 1)
            for i in range(int(rng.integers(0, 20)))}


PAYLOADS = {"ints": _ints, "strs": _strs, "bins": _bins,
            "containers": _containers, "floats": _floats,
            "nested": lambda rng: [_nested(rng) for _ in range(40)]}


class TestCodec:
    @pytest.mark.parametrize("family", sorted(PAYLOADS))
    def test_bytes_and_values_equal_msgpack(self, family):
        rng = np.random.default_rng(RNG_SEED)
        for obj in PAYLOADS[family](rng):
            assert_codec_agrees(obj)
        assert_codec_agrees(PAYLOADS[family](rng))     # all in one array

    def test_subclasses_pack_as_their_base(self):
        for obj in (np.float64(2.5), np.str_("abc"), True, [np.float64(1)]):
            assert _msgpack.packb(obj) == msgpack.packb(obj)

    def test_only_bytes_pack_as_bin(self):
        """The files hold ``bytes`` only; the codec refuses the other
        buffers msgpack would take."""
        for obj in (bytearray(b"xy"), memoryview(b"xy")):
            with pytest.raises(TypeError):
                _msgpack.packb(obj)

    @pytest.mark.parametrize("bad", [np.int64(3), np.bool_(True),
                                     np.float32(1.0), {1, 2}, object()],
                             ids=["int64", "bool_", "float32", "set",
                                  "object"])
    def test_unwritable_types_raise_type_error_in_both(self, bad):
        with pytest.raises(TypeError):
            msgpack.packb({"x": [bad]})
        with pytest.raises(TypeError):
            _msgpack.packb({"x": [bad]})

    def test_out_of_range_ints_overflow_in_both(self):
        for v in (2**64, -2**63 - 1):
            with pytest.raises(OverflowError):
                msgpack.packb(v)
            with pytest.raises(OverflowError):
                _msgpack.packb(v)

    @pytest.mark.parametrize("raw", [b"", b"\xc1", b"\x92\x01", b"\x01\x02",
                                     b"\xd9\x05ab", b"\x81\x01\x02",
                                     b"\x81\xc0\x01", b"\xcb\x00\x00"],
                             ids=["empty", "reserved", "short_array",
                                  "trailing", "short_str", "int_key",
                                  "nil_key", "short_float"])
    def test_garbage_raises_value_error_in_both(self, raw):
        with pytest.raises(ValueError):
            msgpack.unpackb(raw)
        with pytest.raises(ValueError):
            _msgpack.unpackb(raw)

    def test_truncations_of_a_manifest_raise(self, tmp_path):
        jckpt.save_arrays(str(tmp_path), 1, {"w": np.arange(8.0)})
        blob = open(tmp_path / "step_00000001" / "manifest.msgpack",
                    "rb").read()
        for cut in range(len(blob)):
            with pytest.raises(ValueError):
                _msgpack.unpackb(blob[:cut])

    def test_real_manifests(self, tmp_path):
        """A manifest ``repro`` wrote decodes to msgpack's value and packs
        back to the file's bytes."""
        from repro.engine import RetrievalEngine as JEngine

        rng = np.random.default_rng(RNG_SEED)
        jckpt.save_checkpoint(str(tmp_path / "a"), 3, {
            "w": jnp.ones((3, 2), jnp.bfloat16), "b": [jnp.arange(4)]},
            extra={"note": "x", "n": 7})
        eng = JEngine(16, d_start=4, k0=8, capacity=32, backend="ivf",
                      backend_opts=dict(n_lists=4, n_probe=2,
                                        min_index_rows=8))
        eng.enable_durability(str(tmp_path / "b"))
        eng.add_docs(rng.normal(size=(40, 16)).astype(np.float32),
                     tenant="t", metadata=[{"lang": "en", "n": i}
                                           for i in range(40)])
        eng.search(rng.normal(size=(2, 16)).astype(np.float32))
        eng.save_snapshot()
        eng.wal.close()
        paths = [os.path.join(tmp_path / "a", "step_00000003"),
                 os.path.join(tmp_path / "b", "step_00000001")]
        for path in paths:
            blob = open(os.path.join(path, "manifest.msgpack"), "rb").read()
            got = _msgpack.unpackb(blob)
            assert same_value(got, msgpack.unpackb(blob))
            assert _msgpack.packb(got) == blob

    def test_real_wal_bodies(self, tmp_path):
        """Every record body of a ``repro`` WAL decodes to msgpack's value
        and packs back to the logged bytes."""
        from repro.engine import RetrievalEngine as JEngine
        from repro.engine.wal import _HEADER, _MAGIC

        rng = np.random.default_rng(RNG_SEED)
        eng = JEngine(16, d_start=4, k0=8, capacity=32)
        eng.enable_durability(str(tmp_path))
        eng.add_docs(rng.normal(size=(5, 16)).astype(np.float32),
                     metadata={"lang": "de", "score": 0.5, "ok": True})
        eng.add_docs(rng.normal(size=(300, 16)).astype(np.float32),
                     tenant="acme")
        eng.delete_docs(list(range(0, 300, 3)))
        eng.wal.close()
        [seg] = os.listdir(tmp_path / "wal")
        blob = open(tmp_path / "wal" / seg, "rb").read()
        assert blob.startswith(_MAGIC)
        off, n = len(_MAGIC), 0
        while off < len(blob):
            length, _ = _HEADER.unpack_from(blob, off)
            body = blob[off + _HEADER.size: off + _HEADER.size + length]
            got = _msgpack.unpackb(body)
            assert same_value(got, msgpack.unpackb(body))
            assert _msgpack.packb(got) == body
            off += _HEADER.size + length
            n += 1
        assert n == 3


# -- mirrors of tests/test_train_and_ckpt.py::TestCheckpoint -----------------

class TestCheckpoint:
    def test_roundtrip(self, tmp_path):
        tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
                "b": [torch.ones((4,), dtype=torch.bfloat16),
                      torch.zeros((2,), dtype=torch.int32)]}
        save_checkpoint(str(tmp_path), 7, tree)
        restored, step = restore_checkpoint(str(tmp_path), tree)
        assert step == 7
        want = [tree["a"], *tree["b"]]
        got = [restored["a"], *restored["b"]]
        for a, b in zip(want, got):
            assert a.dtype == b.dtype
            assert torch.equal(a, b)

    def test_retention(self, tmp_path):
        tree = {"x": torch.zeros((2,))}
        for s in range(6):
            save_checkpoint(str(tmp_path), s, tree, keep=3)
        assert all_steps(str(tmp_path)) == [3, 4, 5]

    def test_partial_write_ignored(self, tmp_path):
        tree = {"x": torch.zeros((2,))}
        save_checkpoint(str(tmp_path), 1, tree)
        # simulate a crash mid-write: tmp dir without manifest
        os.makedirs(tmp_path / "step_00000002.tmp")
        # and a renamed dir missing its manifest
        os.makedirs(tmp_path / "step_00000003")
        assert latest_step(str(tmp_path)) == 1

    def test_async_manager(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))
        tree = {"x": torch.arange(4.0)}
        mgr.save_async(3, tree)
        tree["x"].add_(100.0)          # the save copied the tree already
        mgr.wait()
        restored, step = mgr.restore({"x": torch.zeros(4)})
        assert step == 3
        assert torch.equal(restored["x"], torch.arange(4.0))


# -- mirrors of tests/test_faults.py::TestCorruptCheckpoint ------------------

class TestCorruptCheckpoint:
    def test_flipped_array_byte_detected(self, tmp_path):
        save_arrays(str(tmp_path), 1, {"w": np.arange(32, dtype=np.float32)})
        npz = os.path.join(tmp_path, "step_00000001", "arrays.npz")
        blob = bytearray(open(npz, "rb").read())
        blob[len(blob) // 2] ^= 0xFF
        open(npz, "wb").write(bytes(blob))
        with pytest.raises(CorruptCheckpoint):
            load_arrays(str(tmp_path), step=1)

    def test_manifest_garbage_detected(self, tmp_path):
        save_arrays(str(tmp_path), 1, {"w": np.zeros(4, np.float32)})
        manifest = os.path.join(tmp_path, "step_00000001",
                                "manifest.msgpack")
        open(manifest, "wb").write(b"\xc1 not msgpack")
        with pytest.raises(CorruptCheckpoint):
            load_arrays(str(tmp_path), step=1)


# -- across packages ---------------------------------------------------------

def _manifest(path):
    with open(os.path.join(path, "manifest.msgpack"), "rb") as f:
        m = msgpack.unpackb(f.read())
    m.pop("time")
    return m


def _trees(seed):
    """The same nested tree for both packages: unsorted dict keys, a
    tuple, a list, ``None`` subtrees and a bfloat16 leaf."""
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(5, 3)).astype(np.float32)
    h = rng.normal(size=(7,)).astype(np.float32)
    ids = rng.integers(-50, 50, (4, 2)).astype(np.int32)
    mask = rng.random(6) < 0.5
    jtree = {"zeta": (jnp.asarray(w), None),
             "alpha": [jnp.asarray(h, jnp.bfloat16), {"m": jnp.asarray(mask),
                                                      "i": jnp.asarray(ids)}],
             "none": None}
    ptree = {"zeta": (torch.from_numpy(w), None),
             "alpha": [torch.from_numpy(h).to(torch.bfloat16),
                       {"m": torch.from_numpy(mask),
                        "i": torch.from_numpy(ids)}],
             "none": None}
    return jtree, ptree


def _bits(x):
    """A leaf of either package as comparable numpy bits."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


class TestAcrossPackages:
    def test_port_reads_reference_checkpoint(self, tmp_path):
        jtree, ptree = _trees(1)
        jckpt.save_checkpoint(str(tmp_path), 4, jtree)
        restored, step = restore_checkpoint(str(tmp_path), ptree)
        assert step == 4
        jleaves = jax.tree.leaves(jtree)
        pleaves, _ = pckpt._leaves(restored)
        assert len(pleaves) == len(jleaves) == 4
        for p, j in zip(pleaves, jleaves):
            assert str(p.dtype).removeprefix("torch.") == str(j.dtype)
            np.testing.assert_array_equal(_bits(p), _bits(j))
        assert restored["zeta"][1] is None and restored["none"] is None

    def test_reference_reads_port_checkpoint(self, tmp_path):
        jtree, ptree = _trees(2)
        save_checkpoint(str(tmp_path / "p"), 5, ptree)
        jckpt.save_checkpoint(str(tmp_path / "j"), 5, jtree)
        restored, step = jckpt.restore_checkpoint(str(tmp_path / "p"), jtree)
        assert step == 5
        for a, b in zip(jax.tree.leaves(restored), jax.tree.leaves(jtree)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(_bits(a), _bits(b))
        # the manifests agree key for key (the treedef string included),
        # the write time apart
        assert _manifest(tmp_path / "p" / "step_00000005") \
            == _manifest(tmp_path / "j" / "step_00000005")

    def test_named_arrays_both_ways(self, tmp_path):
        rng = np.random.default_rng(3)
        arrays = {"store/db": rng.normal(size=(9, 4)).astype(np.float32),
                  "store/valid": rng.random(9) < 0.7,
                  "index/lists": rng.integers(-1, 9, (3, 5)).astype(np.int32),
                  "index/codes": rng.integers(0, 256, (9, 2)).astype(np.uint8)}
        extra = {"wal_seq": 12, "store_meta": {"size": 9, "tenants": ["a"]}}
        jckpt.save_arrays(str(tmp_path / "j"), 13, arrays, extra=extra)
        save_arrays(str(tmp_path / "p"), 13,
                    {k: torch.from_numpy(v) for k, v in arrays.items()},
                    extra=extra)
        for src, reader in ((tmp_path / "j", load_arrays),
                            (tmp_path / "p", jckpt.load_arrays)):
            got, got_extra, step = reader(str(src))
            assert step == 13 and got_extra["wal_seq"] == 12
            assert got_extra["store_meta"] == extra["store_meta"]
            assert sorted(got) == sorted(arrays)
            for k, v in arrays.items():
                assert got[k].dtype == v.dtype
                np.testing.assert_array_equal(got[k], v)
        assert _manifest(tmp_path / "p" / "step_00000013") \
            == _manifest(tmp_path / "j" / "step_00000013")

    def test_bfloat16_bits_and_crcs_equal(self, tmp_path):
        rng = np.random.default_rng(4)
        raw = rng.integers(0, 1 << 16, 64, dtype=np.uint16)
        raw[:4] = [0x7FC1, 0xFF80, 0x8000, 0x0001]      # NaN, -inf, -0, tiny
        j = jnp.asarray(raw).view(jnp.bfloat16)
        p = torch.from_numpy(raw.view(np.int16).copy()).view(torch.bfloat16)
        jckpt.save_arrays(str(tmp_path / "j"), 1, {"w": j})
        save_arrays(str(tmp_path / "p"), 1, {"w": p})
        got, _, _ = load_arrays(str(tmp_path / "j"))
        assert got["w"].dtype == torch.bfloat16
        np.testing.assert_array_equal(_bits(got["w"]), raw)
        back, _, _ = jckpt.load_arrays(str(tmp_path / "p"))
        np.testing.assert_array_equal(_bits(back["w"]), raw)
        crc_j = _manifest(tmp_path / "j" / "step_00000001")["checksums"]
        crc_p = _manifest(tmp_path / "p" / "step_00000001")["checksums"]
        assert crc_p == crc_j == {"arr_0": jckpt._array_crc(np.asarray(j))}
        for a in (rng.normal(size=(33, 7)).astype(np.float32),
                  np.asfortranarray(rng.normal(size=(5, 6))),
                  rng.integers(0, 9, 17).astype(np.int64)):
            assert pckpt._array_crc(a) == jckpt._array_crc(a)
