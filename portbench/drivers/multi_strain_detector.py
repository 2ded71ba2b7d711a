"""Driver of ``MultiStrainDetector.quantify_all`` (``strainer2_tools
detect-multi``): one detector over every strain of the configuration built
in set-up, one call a pass over the mix's batch list into a directory of
hits files of its own, one a strain (gzip level 9, as the stage writes
them)."""

import gzip
import io
import os
import shutil

from pbcore import bytecount, reference
from pbcore.harness import load

# the single-strain driver's configuration and packer serve here too
_single = load(os.path.join(os.path.dirname(os.path.abspath(__file__)), "strain_detector.py"),
               "portbench_driver_strain_detector")
_cfg, pack = _single._cfg, _single.pack

STEP, FAMILY = "multi_classify", "detect"


def _outs(cell, i):
    d = os.path.join(cell.dir, f"multi_{i}")
    return d, [os.path.join(d, f"{s.name}.kmer_hits.gz") for s in cell.inputs.strains]


def step_bytes(stats, cell) -> int:
    return bytecount.classify_bytes(stats, len(cell.inputs.strains))


def build(cell):
    from strainer2_tpu_torch.pipeline.multi_detect import MultiStrainDetector

    pairs = [(s.path, s.informative_path) for s in cell.inputs.strains]
    return MultiStrainDetector(pairs, _cfg(cell), stdout=io.StringIO())


def _run(det, cell, name, batch_list):
    d, paths = _outs(cell, name)
    os.makedirs(d, exist_ok=True)
    det.quantify_all(paths, batch_list)


def warm(det, cell) -> None:
    _run(det, cell, "warm", cell.inputs.warm_batch_list)


def call(det, cell, i: int) -> int:
    _run(det, cell, i, cell.inputs.batch_list)
    return cell.inputs.target_windows()


def answers(cell, i: int) -> list:
    d, paths = _outs(cell, i)
    out = []
    for p in paths:
        with open(p, "rb") as f:
            out.append(gzip.decompress(f.read()))
    shutil.rmtree(d)
    return out


def expected(cell, fingerprinted: bool):
    return reference.detect_expected(cell.inputs.strains, cell.inputs.samples,
                                     cell.config["k"], cell.device, fingerprinted)
