"""The port's measured ``.mat`` tree (``data/mat_native.py``,
``data/mat_loader.py``, ``data/mat_sampler.py``) against the JAX package's.

* ``HoloMatDataset``: the records (paths, distances, ground-truth paths)
  and every item's arrays equal the JAX package's bit for bit, on the
  committed RBC fixture (both splits) and on ``tmp_path`` trees of the
  generic, polystyrene/tissue fov and RBC layouts (domain inferred from the
  root's name, and given); ``batches`` alike, ragged tail included.
  A preset alias (``rbc``, ``polystyrene_bead``, ``mnist``) reads the layout
  it names.
* ``read_mat_2d`` against ``scipy.io`` (uncompressed and compressed, four
  element types, a second variable), and None where the variable is absent;
  ``load_matfile`` falls back to ``scipy.io`` then.
* ``MeasuredHologramSampler``: its batches (``default_rng((seed, i))``, crop
  and flip), its resume and its ``style_batches`` equal the JAX package's
  bit for bit, on the fixture and on a tree whose frames exceed the patch;
  its refusals (no frames at a distance, a frame smaller than the patch).
"""

import os

import numpy as np
import pytest
import scipy.io as sio

from style_transfer_based_holographic_imaging_tpu.config import DataConfig as JData
from style_transfer_based_holographic_imaging_tpu.config import PhysicsConfig as JPhysics
from style_transfer_based_holographic_imaging_tpu.data import mat_loader as jloader
from style_transfer_based_holographic_imaging_tpu.data import mat_native as jnative
from style_transfer_based_holographic_imaging_tpu.data import mat_sampler as jsampler
from style_transfer_based_holographic_imaging_tpu_torch.config import DataConfig, PhysicsConfig
from style_transfer_based_holographic_imaging_tpu_torch.data import mat_loader, mat_native, mat_sampler

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "rbc_mat_tree", "red_blood_cell")
RBC_D = (4.0, 5.0, 6.0, 7.0, 8.0)


def _write(path, key, arr, compress=False):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    sio.savemat(path, {key: arr}, do_compression=compress)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """Trees of the three layouts: (root, split, distances, domain) cases."""
    base = tmp_path_factory.mktemp("mat_trees")
    rng = np.random.default_rng(0)
    generic = base / "sample_domain"
    for d in (5.0, 6.0):
        for j in range(3):
            _write(str(generic / "train" / "holography" / ("%1.2f" % d) / f"h{j}.mat"),
                   "holography", rng.random((32, 32)))
    poly = base / "polystyrene_bead"
    for fov in (1, 2, 16):
        for d in (5, 6):
            root = poly / f"fov{fov}" / "test"
            _write(str(root / "holography" / str(d) / "h0.mat"), "holography",
                   rng.random((16, 16)).astype(np.float32))
            if fov != 2 or d != 6:  # one fov without its ground truth
                _write(str(root / "gt_amplitude" / f"gt_amplitude{d - 4}.mat"), "gt_amplitude",
                       rng.random((16, 16)), compress=True)
                _write(str(root / "gt_phase" / f"gt_phase{d - 4}.mat"), "gt_phase", rng.random((16, 16)))
    tissue = base / "tissue_sample"
    for d in (5, 7):
        _write(str(tissue / "train" / "holography" / str(d) / "a.mat"), "holography", rng.random((8, 8)))
    rbc = base / "rbc_run"
    for d, n in ((6.0, 5), (7.0, 3)):
        for j in range(1, n + 1):
            _write(str(rbc / "test" / "holography" / ("%1.1f" % d) / f"holography{j}.mat"),
                   "holography", (rng.random((16, 16)) * 255).astype(np.uint8))
    for j in (1, 2):
        _write(str(rbc / "test" / "gt_phase" / f"holography{j}.mat"), "gt_phase", rng.random((16, 16)))
    return {
        "generic_train": (str(generic), "train", (5.0, 6.0, 7.0), None),
        "generic_given": (str(generic), "train", (6.0,), "generic"),
        "poly_fov_test": (str(poly), "test", (5, 6), None),
        "poly_as_tissue": (str(poly), "test", (6,), "tissue"),
        "tissue_train": (str(tissue), "train", (5.0, 7.0), None),
        "rbc_test": (str(rbc), "test", (6.0, 7.0), None),
        "rbc_given": (str(rbc), "test", (6.0, 7.0), "red_blood_cell"),
        "fixture_train": (FIXTURE, "train", RBC_D, None),
        "fixture_test": (FIXTURE, "test", (4.0, 6.0, 8.0), "red_blood_cell"),
    }


def _equal_items(a, b):
    assert set(a) == set(b)
    for k in a:
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("case", ["generic_train", "generic_given", "poly_fov_test", "poly_as_tissue",
                                  "tissue_train", "rbc_test", "rbc_given", "fixture_train",
                                  "fixture_test"])
def test_dataset_records_items_and_batches(trees, case):
    root, split, distances, domain = trees[case]
    want = jloader.HoloMatDataset(root, split, distances, domain=domain)
    got = mat_loader.HoloMatDataset(root, split, distances, domain=domain)
    assert got.domain == want.domain
    assert len(got) == len(want) > 0
    assert [tuple(vars(r).values()) for r in got.records] == [tuple(vars(r).values()) for r in want.records]
    for i in range(len(want)):
        _equal_items(got[i], want[i])
    for bg, bw in zip(got.batches(2), want.batches(2), strict=True):
        _equal_items(bg, bw)


@pytest.mark.parametrize("alias,case", [("rbc", "rbc_test"), ("polystyrene_bead", "poly_fov_test"),
                                        ("mnist", "generic_train")])
def test_dataset_resolves_preset_aliases(trees, alias, case):
    """A preset alias reads the tree layout it names (the JAX package's
    dataset takes layouts only: it is given the layout)."""
    root, split, distances, _ = trees[case]
    layout = mat_loader.DOMAIN_LAYOUTS[alias]
    want = jloader.HoloMatDataset(root, split, distances, domain=layout)
    got = mat_loader.HoloMatDataset(root, split, distances, domain=alias)
    assert got.domain == want.domain == layout
    assert len(got) == len(want) > 0
    assert [tuple(vars(r).values()) for r in got.records] == [tuple(vars(r).values()) for r in want.records]


def test_fixture_layout():
    train = mat_loader.HoloMatDataset(FIXTURE, "train", RBC_D)
    test = mat_loader.HoloMatDataset(FIXTURE, "test", (4.0, 6.0, 8.0))
    assert len(train) == 15 and len(test) == 9
    item = test[0]
    assert item["holo"].shape == (1, 128, 128) and {"gt_phase", "gt_amplitude"} <= set(item)


def test_native_reader_against_scipy(tmp_path):
    assert mat_native.native_available()
    rng = np.random.default_rng(0)
    cases = {
        "f64": rng.standard_normal((17, 23)),
        "f32": rng.standard_normal((8, 8)).astype(np.float32),
        "u8": (rng.random((5, 9)) * 255).astype(np.uint8),
        "i16": (rng.random((4, 6)) * 1000 - 500).astype(np.int16),
    }
    for compress in (False, True):
        for name, arr in cases.items():
            p = str(tmp_path / f"{name}_{compress}.mat")
            sio.savemat(p, {"first": rng.random((3, 4)), "holography": arr}, do_compression=compress)
            got = mat_native.read_mat_2d(p, "holography")
            assert got is not None and got.dtype == np.float64, (name, compress)
            np.testing.assert_array_equal(got, sio.loadmat(p)["holography"].astype(np.float64))
            np.testing.assert_array_equal(got, jnative.read_mat_2d(p, "holography"))
    p = str(tmp_path / "other.mat")
    sio.savemat(p, {"other": np.ones((3, 3))})
    assert mat_native.read_mat_2d(p, "holography") is None
    assert "other" in mat_loader.load_matfile(p, "holography")
    holo = os.path.join(FIXTURE, "test", "holography", "6.0", "holography1.mat")
    np.testing.assert_array_equal(mat_loader.load_matfile(holo, "holography")["holography"],
                                  sio.loadmat(holo)["holography"])


@pytest.fixture(scope="module")
def big_tree(tmp_path_factory):
    """RBC-layout train split with frames larger than the patch (40 x 48)."""
    root = tmp_path_factory.mktemp("rbc_big") / "red_blood_cell"
    rng = np.random.default_rng(1)
    for d in (4.0, 5.0, 6.0):
        for j in range(3):
            _write(str(root / "train" / "holography" / ("%1.1f" % d) / f"h{j}.mat"), "holography",
                   rng.random((40, 48)) * 2.0 - 0.1)
    return str(root)


SAMPLER_CASES = {
    # (tree, data fields, physics, domain)
    "fixture_rbc": ("fixture", dict(batch_size=3, image_size=64, style_distances=(6.0,),
                                    content_distances=RBC_D, seed=5), dict(distance_normalize=10.0),
                    "red_blood_cell"),
    "fixture_alias": ("fixture", dict(batch_size=2, image_size=128, style_distances=(6.0,),
                                      content_distances=(4.0, 8.0), seed=0), dict(distance_normalize=10.0),
                      "rbc"),
    "big_no_flip": ("big", dict(batch_size=4, image_size=32, style_distances=(6.0,),
                                content_distances=(4.0, 5.0), flip=False, seed=2), {}, None),
}


@pytest.mark.parametrize("case", sorted(SAMPLER_CASES))
def test_sampler_batches_and_style_batches(case, big_tree):
    tree, data_kw, phys_kw, domain = SAMPLER_CASES[case]
    root = FIXTURE if tree == "fixture" else big_tree
    want = jsampler.MeasuredHologramSampler(root, JData(**data_kw), JPhysics(**phys_kw), domain=domain)
    got = mat_sampler.MeasuredHologramSampler(root, DataConfig(**data_kw), PhysicsConfig(**phys_kw),
                                              domain=domain)
    assert (got.n_content, got.n_style, len(got.ds)) == (want.n_content, want.n_style, len(want.ds))
    for _ in range(3):
        _equal_items(next(got), next(want))
    # resumed as train() resumes it: the next batch's index set to the step
    resumed = mat_sampler.MeasuredHologramSampler(root, DataConfig(**data_kw), PhysicsConfig(**phys_kw),
                                                  domain=domain)
    resumed.iteration = 2
    want2 = jsampler.MeasuredHologramSampler(root, JData(**data_kw), JPhysics(**phys_kw), domain=domain,
                                             start_iteration=2)
    _equal_items(next(resumed), next(want2))
    for g, w in zip(got.style_batches(3), want.style_batches(3), strict=True):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype == np.float32
    for g, w in zip(got.style_batches(2, seed=9), want.style_batches(2, seed=9), strict=True):
        np.testing.assert_array_equal(g, w)


def test_sampler_refusals(big_tree):
    with pytest.raises(ValueError, match="no content frames"):
        mat_sampler.MeasuredHologramSampler(
            big_tree, DataConfig(image_size=32, style_distances=(6.0,), content_distances=(9.0,)),
            PhysicsConfig())
    with pytest.raises(ValueError, match="no style frames"):
        mat_sampler.MeasuredHologramSampler(
            big_tree, DataConfig(image_size=32, style_distances=(9.0,), content_distances=(4.0,)),
            PhysicsConfig())
    with pytest.raises(ValueError, match="smaller than the train patch"):
        mat_sampler.MeasuredHologramSampler(
            big_tree, DataConfig(image_size=64, style_distances=(6.0,), content_distances=(4.0,)),
            PhysicsConfig())
