"""Driver of ``run_scrub_count`` (the ``kmer_scrub_count`` stage entry):
the strain's index built in set-up (``StrainIndex.from_fasta``), one call
a count of -A and -B into a table written to an in-memory sink, which
stands for the CLI's stdout pipe."""

import io
import os
import time
from concurrent.futures import ThreadPoolExecutor

from pbcore import bytecount, reference

STEP, FAMILY = "count", "count"


def _cfg(cell):
    from strainer2_tpu_torch.pipeline.scrub_count import ScrubCountConfig

    c = cell.config
    return ScrubCountConfig(k=c["k"], rows=c["rows"], row_len=c["row_len"], device=cell.device,
                            layout=c["layout"])


def build(cell):
    from strainer2_tpu_torch.index.build import StrainIndex
    from strainer2_tpu_torch.pipeline.engine import TorchKmerEngine

    c = cell.config
    engine = TorchKmerEngine(c["k"], device=cell.device, layout=c["layout"])
    index = StrainIndex.from_fasta(cell.inputs.strains[0].path, engine, c["rows"], c["row_len"])
    index.table  # built on first use: the stage builds it with the index
    return index


def _run(index, cell, panel) -> bytes:
    from strainer2_tpu_torch.pipeline.scrub_count import run_scrub_count

    sink = io.TextIOWrapper(io.BytesIO(), encoding="ascii")
    run_scrub_count(cell.inputs.strains[0].path, panel.a_list, panel.b_list, out=sink,
                    cfg=_cfg(cell), index=index)
    sink.flush()
    return sink.buffer.getvalue()


def warm(index, cell) -> None:
    _run(index, cell, cell.inputs.warm_panel)


def call(index, cell, i: int) -> int:
    cell.store[i] = _run(index, cell, cell.inputs.panel)
    return cell.inputs.panel_windows()


def answers(cell, i: int) -> list:
    return [cell.store.pop(i)]


def expected(cell, fingerprinted: bool):
    table, stats = reference.count_expected(cell.inputs.strains[0], cell.inputs.panel,
                                            cell.config["k"], cell.device, fingerprinted)
    return [table], stats


def step_bytes(stats, cell) -> int:
    return bytecount.count_bytes(stats)


def pack(cell):
    """The port's packer alone over the distinct panel files, on as many
    threads as the stage feeds the device with: min(cores, 8, files)."""
    from strainer2_tpu_torch import native

    c = cell.config
    p = cell.inputs.panel
    paths = [path for path, _ in p.genomes] + [path for path, _ in p.metagenomes]

    def one(path):
        for _ in native.pack_file(path, c["k"], c["rows"], c["row_len"]):
            pass

    t = time.perf_counter()
    with ThreadPoolExecutor(max(1, min(os.cpu_count() or 1, 8, len(paths)))) as ex:
        list(ex.map(one, paths))
    return cell.inputs.distinct_panel_windows(), time.perf_counter() - t
