"""chip_smoke.py at tiny sizes on the CPU test mesh: every phase's gates,
the no-GPU refusal, and the four-device mesh phase on virtual devices.

The phases compare against the platform's own expectations (backend.py),
so on the CPU the host encoder is the one phase 1 requires.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import bench  # noqa: E402
import chip_smoke  # noqa: E402

SIZE = 300  # 21 full 4096-sample frames + a 3984-sample tail
TILE = 128  # 3 x 3 tiles, 44-px clipped edges


@pytest.fixture(scope="module")
def raster():
    return bench.make_raster(SIZE, seed=1)


@pytest.fixture(scope="module")
def scene(raster, tmp_path_factory):
    workdir = tmp_path_factory.mktemp("scene")
    return workdir, chip_smoke.phase_scene(workdir, raster)


def test_make_raster_is_seeded(raster):
    assert raster.dtype == np.uint16 and raster.shape == (SIZE, SIZE)
    assert np.array_equal(raster, bench.make_raster(SIZE, seed=1))
    assert not np.array_equal(raster, bench.make_raster(SIZE, seed=2))


def test_phase_scene(scene, raster):
    _, info = scene
    assert info["encoder"] == "encode_flac_fast"  # the CPU table's encoder
    assert info["frames"] == SIZE * SIZE // 4096
    assert info["tail_samples"] == SIZE * SIZE % 4096 > 0


def test_phase_crosscheck(raster):
    info = chip_smoke.phase_crosscheck(raster, 8)
    # on the CPU both encoders run the same planner: identical bytes
    assert info["identical"] and info["first_diff_frame"] is None
    assert info["size_rel"] == 0.0


def test_phase_resident(scene, raster):
    _, info = scene
    res = chip_smoke.phase_resident(info["blob"], raster)
    assert res["decode_engine"] == "device"
    args, kwargs = res["decode_frames_device.args"]
    assert kwargs["N"] == 4096 and kwargs["C"] == 1


def test_phase_spatial(scene, raster):
    workdir, info = scene
    res = chip_smoke.phase_spatial(workdir, info["tif"], raster, TILE)
    assert res["tiles"] == 9 and res["edge_tile"] == "44x44"


def test_phase_wide():
    dem = chip_smoke.make_dem(100, seed=3)
    assert dem.dtype == np.float32
    info = chip_smoke.phase_wide(dem)
    assert info["ratio"] > 1.0


def test_phase_fuzz():
    info = chip_smoke.phase_fuzz(seed=4, n_verified=12, n_differential=6)
    assert info["exact"] + info["raised"] == 12


def test_four_mesh_on_virtual_devices(raster, tmp_path):
    info = chip_smoke.four_mesh(raster, TILE, tmp_path)
    assert info["tiles"] == 9 and info["bbox_tiles"] > 1
    # CPU: every program plans alike, so the mesh bytes equal the
    # one-device bytes
    assert info["size_rel_max"] == 0.0
    # every emitting step's index was checked: 4x1 mesh 1+1+1 groups, 2x2
    # mesh 2+1+1 (the 128x44 tiles pad 1 frame to 2 on the blocks axis; the
    # 44x44 tile has no full frame and never reaches the mesh)
    assert info["index_groups_exact"] == 7


def test_full_frame_bytes_excludes_tail():
    from flac_raster_tpu.codec.fast_encoder import encode_flac_fast
    from flac_raster_tpu.models.flac_format import (
        parse_flac_metadata,
        parse_layout_block,
    )

    x = np.cumsum(np.random.default_rng(6).integers(-9, 10, (3 * 4096 + 77, 1)),
                  axis=0).astype(np.int32)
    blob = encode_flac_fast(x, 44100, 16, 5)
    _, blocks, start = parse_flac_metadata(blob)
    tail = int(parse_layout_block(blocks).sizes[-1])
    assert chip_smoke.full_frame_bytes(blob) == len(blob) - start - tail
    full = encode_flac_fast(x[: 3 * 4096], 44100, 16, 5)
    assert chip_smoke.full_frame_bytes(full) == len(full) - parse_flac_metadata(full)[2]


def test_first_differing_frame(raster):
    from flac_raster_tpu.codec.fast_encoder import encode_flac_fast

    pcm = (raster.ravel()[: 3 * 4096].astype(np.int32) - 32768)[:, None]
    a = encode_flac_fast(pcm, 44100, 16, 5)
    assert chip_smoke.first_differing_frame(a, a) is None
    b = bytearray(a)
    b[-5] ^= 0xFF  # inside the last frame
    assert chip_smoke.first_differing_frame(a, bytes(b)) == 2


def test_gate_raises():
    chip_smoke.gate(True, "fine")
    with pytest.raises(chip_smoke.SmokeFailure, match="broken"):
        chip_smoke.gate(False, "broken")


@pytest.mark.parametrize("argv", [[], ["--four"]])
def test_main_refuses_without_gpu(argv, capsys):
    rc = chip_smoke.main(argv)
    out, err = capsys.readouterr()
    assert rc != 0
    assert '"ok"' not in out
    assert "no GPU" in err


def test_bench_refuses_without_gpu(capsys):
    assert bench.main() != 0
    out, err = capsys.readouterr()
    assert out == "" and "no GPU" in err


def test_require_gpu_raises_on_cpu():
    with pytest.raises(RuntimeError, match="no GPU"):
        bench.require_gpu()


def test_ok_line_shape(capsys, monkeypatch):
    """With a (stubbed) GPU and no phases, the last stdout line is exactly
    the driver's JSON object."""
    fake = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
            "gpu": "NVIDIA H100 80GB HBM3, 700.00 W"}
    monkeypatch.setattr(bench, "require_gpu", lambda: fake)
    monkeypatch.setattr(bench, "make_raster", lambda size, seed: np.zeros((2, 2)))
    monkeypatch.setattr(chip_smoke, "run_phases", lambda *a: None)
    assert chip_smoke.main([]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert "700.00 W" in lines[0]
    assert json.loads(lines[-1]) == {
        "ok": True,
        "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
                   "count": 1},
    }
