"""`correct` holds sound runs and fails the control and the faults the
cell can have, on the tiny configuration on the CPU."""

import pytest
import torch

from kslam_tpu_torch.config import SWParams
from kslam_tpu_torch.parallel import dist
from kslam_tpu_torch.pipeline import classify, device_path, run as prun
from portbench.reference import chunk as ref
from portbench.tests import tiny
from portbench.tests.harness import tiny_run


def test_sound_run_is_correct():
    res = tiny_run(seed=2**33 + 5, traffic="host-rich")
    assert res["correct"] is True
    assert all(c["value"] == 0 for c in res["compared"].values())


def test_control_is_not_correct():
    """The reference with SW saturating at 255 in the program's place:
    the run reports `correct` false."""
    res = tiny_run(seed=7, control="sw8")
    assert res["compared"]["taxid_mismatches"]["value"] > 0
    assert res["correct"] is False


def _half_the_batch(monkeypatch):
    real = device_path.phase_a

    def phase_a(bases, lengths, midpoint, *a, **k):
        lengths = lengths.clone()
        lengths[len(lengths) // 4:midpoint] = 0      # R1 of half the pairs
        lengths[midpoint + len(lengths) // 4:] = 0   # and their R2
        return real(bases, lengths, midpoint, *a, **k)
    monkeypatch.setattr(device_path, "phase_a", phase_a)


def _answer_altered(monkeypatch):
    real = device_path.phase_b_finish

    def finish(*a, **k):
        out = real(*a, **k)
        lca = out.read_lca.clone()
        if len(lca):
            lca[0] = lca[0] + 1
        return out._replace(read_lca=lca)
    monkeypatch.setattr(device_path, "phase_b_finish", finish)


def _results_dropped(monkeypatch):
    real = classify.chunk_taxa_from_arrays

    def taxa(arrs, names, index):
        out = real(arrs, names, index)
        return classify.ChunkTaxa(out.names[::2], out.taxids[::2])
    monkeypatch.setattr(classify, "chunk_taxa_from_arrays", taxa)


@pytest.mark.parametrize("fault", [_half_the_batch, _answer_altered,
                                   _results_dropped])
def test_fault_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    res = tiny_run(seed=7)
    assert res["correct"] is False


@pytest.mark.cuda
def test_tiny_run_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    res = tiny_run(seed=21, device="cuda", trace=1)
    assert res["correct"] is True
    assert res["device"]["busy_s"] > 0


def test_sam_text_altered_is_not_correct(monkeypatch):
    """A CIGAR altered where the SAM text is made fails the SAM lines."""
    from kslam_tpu_torch.io import sam_columns
    real = sam_columns.write_sam

    class Alter:
        def __init__(self, out):
            self.out = out

        def write(self, text):
            self.out.write(text.replace("\t150M\t", "\t149M1I\t", 1))

    def write_sam(out, *a, **k):
        return real(Alter(out), *a, **k)
    monkeypatch.setattr(sam_columns, "write_sam", write_sam)
    res = tiny_run(seed=8, sam=True)
    assert res["compared"]["sam_line_mismatches"]["value"] > 0
    assert res["correct"] is False


def test_sam_run_is_correct():
    res = tiny_run(seed=9, sam=True)
    assert res["correct"] is True
    assert res["compared"]["sam_line_mismatches"]["value"] == 0


def _spy(monkeypatch):
    """What the port's chunk pipeline and the reference are given."""
    seen = {}
    init = prun.ChunkPipeline.__init__

    def pipeline(self, config, *a, **k):
        seen["program"] = config
        seen["mesh"] = k.get("mesh")
        init(self, config, *a, **k)
    classify_ref = ref.classify

    def reference(*a, **k):
        seen.setdefault("reference", a[5])
        return classify_ref(*a, **k)
    monkeypatch.setattr(prun.ChunkPipeline, "__init__", pipeline)
    monkeypatch.setattr(ref, "classify", reference)
    return seen


def test_changed_sw_scores_reach_the_program_and_the_reference(monkeypatch):
    """The configuration's pipeline group is the one source of the run's
    settings: SW scores other than the CLI's reach both sides, and the
    run stays correct."""
    seen = _spy(monkeypatch)
    cfg = tiny.config()
    cfg["pipeline"].update(sw=dict(match=1, mismatch=4, gap_open=6,
                                   gap_extend=1),
                           score_fraction_threshold=0.9, score_threshold=20)
    res = tiny_run(seed=12, cfg=cfg)
    assert seen["program"].sw == SWParams(1, 4, 6, 1)
    assert seen["program"].score_fraction_threshold == 0.9
    assert seen["program"].score_threshold == 20
    assert seen["reference"]["sw"] == (1, 4, 6, 1)
    assert seen["reference"]["fraction"] == 0.9
    assert seen["reference"]["score_threshold"] == 20
    assert res["correct"] is True


def test_mesh_setting_reaches_the_program(monkeypatch):
    """pipeline.mesh_shape places the database over a mesh and runs the
    chunks on it, as the CLI's --mesh does; the run stays correct."""
    seen = _spy(monkeypatch)
    placed = []
    place = dist.place_sharded_db

    def spy_place(*a, **k):
        placed.append(k.get("genome_sharded"))
        return place(*a, **k)
    monkeypatch.setattr(dist, "place_sharded_db", spy_place)
    cfg = tiny.config()
    cfg["pipeline"].update(mesh_shape="1x2", genome_sharded=True)
    res = tiny_run(seed=13, cfg=cfg)
    assert placed == [True]
    assert seen["mesh"] is not None and seen["mesh"].shape["index"] == 2
    assert res["correct"] is True


def test_setting_the_harness_cannot_judge_is_refused():
    cfg = tiny.config()
    cfg["pipeline"]["host_screen_dir"] = "host"
    with pytest.raises(ValueError, match="host_screen_dir"):
        tiny_run(seed=14, cfg=cfg)
