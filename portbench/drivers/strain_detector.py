"""Driver of ``StrainDetector.quantify_all`` (the ``strain_detect -B``
stage entry): one detector built in set-up, one call a pass over the
mix's batch list, written to a hits file of its own (gzip level 9, as the
stage writes it)."""

import gzip
import io
import os
import time

from pbcore import bytecount, reference

STEP, FAMILY = "classify", "detect"


def _cfg(cell):
    from strainer2_tpu_torch.pipeline.detect import DetectConfig

    c = cell.config
    return DetectConfig(k=c["k"], rows=c["rows"], row_len=c["row_len"], device=cell.device,
                        layout=c["layout"])


def _out(cell, i):
    return os.path.join(cell.dir, f"hits_{i}.gz")


def build(cell):
    from strainer2_tpu_torch.pipeline.detect import StrainDetector

    st = cell.inputs.strains[0]
    return StrainDetector(st.path, st.informative_path, _cfg(cell), stdout=io.StringIO())


def warm(det, cell) -> None:
    det.quantify_all(os.path.join(cell.dir, "warm_hits.gz"), batch_list=cell.inputs.warm_batch_list)


def call(det, cell, i: int) -> int:
    det.quantify_all(_out(cell, i), batch_list=cell.inputs.batch_list)
    return cell.inputs.target_windows()


def answers(cell, i: int) -> list:
    with open(_out(cell, i), "rb") as f:
        data = gzip.decompress(f.read())
    os.remove(_out(cell, i))
    return [data]


def expected(cell, fingerprinted: bool):
    return reference.detect_expected(cell.inputs.strains[:1], cell.inputs.samples,
                                     cell.config["k"], cell.device, fingerprinted)


def step_bytes(stats, cell) -> int:
    return bytecount.classify_bytes(stats)


def pack(cell):
    """The port's packer alone over the call's samples, opened as the
    detector opens them (read ids, a pair's mates together), no device."""
    from strainer2_tpu_torch import native
    from strainer2_tpu_torch.io.batches import max_reads_capacity

    c = cell.config
    t = time.perf_counter()
    for s in cell.inputs.samples:
        paired = s.kind == "PE"
        for _ in native.NativePackStream(
                [s.f1, s.f2] if paired else [s.f1], c["k"], c["rows"], c["row_len"],
                mode=1 if paired else 0, with_read_ids=True, group_size=2 if paired else 1,
                max_reads=max_reads_capacity(c["k"], c["rows"], c["row_len"])):
            pass
    return cell.inputs.target_windows(), time.perf_counter() - t
