"""The port's CLI parsers are copies of the JAX CLIs' ``build_parser()``:
the same options (option strings, dests, defaults, requiredness, types,
choices) and the same parsed Namespace on the argv lines the mini goldens
and chip_smoke.py use, once the port's own ``--device`` is left out."""

import argparse

import pytest

import strainer2_tpu.cli.coverage_depth as j_coverage_depth
import strainer2_tpu.cli.genome_compare as j_genome_compare
import strainer2_tpu.cli.kmer_scrub_count as j_kmer_scrub_count
import strainer2_tpu.cli.kmer_scrub_filter as j_kmer_scrub_filter
import strainer2_tpu.cli.strain_detect as j_strain_detect
import strainer2_tpu.cli.strainer2_tools as j_strainer2_tools
import strainer2_tpu_torch.cli.coverage_depth as t_coverage_depth
import strainer2_tpu_torch.cli.genome_compare as t_genome_compare
import strainer2_tpu_torch.cli.kmer_scrub_count as t_kmer_scrub_count
import strainer2_tpu_torch.cli.kmer_scrub_filter as t_kmer_scrub_filter
import strainer2_tpu_torch.cli.strain_detect as t_strain_detect
import strainer2_tpu_torch.cli.strainer2_tools as t_strainer2_tools

PAIRS = {
    "kmer_scrub_count": (t_kmer_scrub_count, j_kmer_scrub_count),
    "kmer_scrub_filter": (t_kmer_scrub_filter, j_kmer_scrub_filter),
    "coverage_depth": (t_coverage_depth, j_coverage_depth),
    "strain_detect": (t_strain_detect, j_strain_detect),
    "genome_compare": (t_genome_compare, j_genome_compare),
    "strainer2_tools": (t_strainer2_tools, j_strainer2_tools),
}

# argv of the mini goldens (tests/test_torch_slice.py, chip_smoke.py phase
# 3), of chip_smoke.py phases 4, 6 and 9, and a few more
ARGV = {
    "kmer_scrub_count": [
        ["-r", "data/strainA.fna.gz", "-A", "data/genomes.txt", "-B", "data/metagenomes.txt"],
        ["-r", "s.fna", "-A", "g.txt", "-B", "m.txt", "-C", "drugs.txt", "-p", "prog.txt",
         "--rows", "8", "--row-len", "512", "--no-reference-order"],
    ],
    "kmer_scrub_filter": [
        ["-s", "expected/scrub_counts.gz", "-m", "0.05"],
        ["-s", "counts.tsv", "-m", "0.01"],
        ["-l", "list.txt", "-i"],
    ],
    "coverage_depth": [
        ["-k", "strainA_x.kmer_hits.gz"],
        ["-k", "hits.gz", "-m", "5", "-b", "data/background.txt"],
    ],
    "strain_detect": [
        ["-r", "data/strainA.fna.gz", "-a", "expected/scrubbed_m05.txt", "-B", "data/targets.txt",
         "-o", "hits.gz"],
        ["-r", "data/strainA.fna.gz", "-a", "expected/scrubbed_m05.txt", "-B", "data/targets.txt",
         "-g", "data/background.txt", "-o", "hits_bg.gz"],
        ["-r", "s.fna", "-a", "inf.txt", "-b", "r1.fq", "-c", "r2.fq", "-t", "PE", "-o", "o.gz",
         "--no-gzip", "--index-cache", "ix.npz", "--rows", "16", "--row-len", "1024"],
    ],
    "strainer2_tools": [
        ["detect-multi", "-S", "strains.tsv", "-B", "targets.txt", "-o", "multi"],
        ["detect-multi", "-S", "strains.tsv", "-B", "targets.txt", "-g", "bg.txt", "-o", "out"],
        ["scrub-multi", "-R", "r.txt", "-A", "a.txt", "-B", "b.txt", "-o", "out"],
        ["pipeline-multi", "-R", "r.txt", "-A", "a.txt", "-B", "b.txt", "-T", "t.txt", "-o", "o",
         "-m", "0.01"],
        ["strain-track", "-A", "a.txt", "-b", "m.fq", "-n", "-m", "100"],
        ["pangenome", "-A", "data/pangenomes.txt", "-r", "data/strainA.fna.gz"],
        ["pangenome", "-A", "data/pangenomes.txt", "-d"],
        ["kmer-matrix", "-A", "data/pangenomes.txt", "-s", "20"],
    ],
    "genome_compare": [
        ["-a", "data/strainA.fna.gz", "-b", "data/panel1.fna.gz", "-H"],
        ["-a", "data/strainA.fna.gz", "-B", "data/compare_list.txt", "-s", "17"],
        ["-a", "data/strainA.fna.gz", "-B", "data/compare_list.txt", "-r", "300", "-t", "0.5"],
        ["-a", "data/strainA.fna.gz", "-B", "data/compare_list.txt", "-S"],
        ["-a", "strain.fna", "-B", "queries.txt", "-C"],
        ["-a", "strain.fna", "-B", "queries.txt", "-r", "3000000", "-t", "0.02"],
    ],
}


@pytest.fixture(autouse=True)
def _torch_route(monkeypatch):
    """The torch engine's CPU programs, the CPU check of the card route's
    logic (STRAINER2_NATIVE_COUNT=0); the JAX runs keep their own route."""
    from tests._torch_route import torch_route

    torch_route(monkeypatch)


def _options(parser: argparse.ArgumentParser) -> list:
    """Every option but --device, with its subcommands' options."""
    out = []
    for a in parser._actions:
        if a.dest == "device" or isinstance(a, argparse._HelpAction):
            continue
        if isinstance(a, argparse._SubParsersAction):
            out.append(("subcommands", sorted(a.choices)))
            for name, sub in sorted(a.choices.items()):
                out.append((name, _options(sub)))
            continue
        out.append((tuple(a.option_strings), a.dest, a.default, a.required, a.type, a.choices,
                    a.nargs, type(a).__name__))
    return out


@pytest.mark.parametrize("cli", sorted(PAIRS))
def test_parser_copy_matches(cli):
    t_mod, j_mod = PAIRS[cli]
    t_parser, j_parser = t_mod.build_parser(), j_mod.build_parser()
    assert _options(t_parser) == _options(j_parser)
    assert t_parser.prog == j_parser.prog
    for argv in ARGV[cli]:
        got = vars(t_parser.parse_args(argv))
        assert got.pop("device") == "cuda"
        assert got == vars(j_parser.parse_args(argv)), argv


@pytest.mark.parametrize("cli", sorted(PAIRS))
def test_every_parser_takes_device(cli):
    t_mod, _ = PAIRS[cli]
    argv = list(ARGV[cli][0])
    argv.append("--device")
    argv.append("cpu")
    assert t_mod.build_parser().parse_args(argv).device == "cpu"
