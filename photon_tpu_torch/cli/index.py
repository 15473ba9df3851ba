"""Build per-shard feature index maps and name-term lists (port of
``photon_tpu/cli/index.py``).

Counterpart of the two vocabulary-builder CLIs:
- FeatureIndexingDriver (photon-client index/FeatureIndexingDriver.scala:42):
  scans input Avro data and builds one name->index store per feature shard
  (partitioned PalDB there; a JSON index map here).
- NameAndTermFeatureBagsDriver (data/avro/NameAndTermFeatureBagsDriver.scala
  :32): extracts the distinct (name, term) set per feature bag to text files
  (the ``feature-lists`` whitelist format: one "name<TAB>term" per line).

A shard unions one or more feature-bag record fields
(FeatureShardConfiguration.featureBags): ``--shards global=features`` or
``--shards user=userFeatures,features``. Outputs per shard:
``<out>/<shard>.index.json`` (IndexMap.save) and ``<out>/<shard>`` (the
whitelist, named like the reference's feature-lists files).

Usage:
    python -m photon_tpu_torch.cli.index --input data.avro --output vocab/ \
        [--shards global=features user=userFeatures] [--no-intercept]
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys


def parse_shard_spec(specs: list[str] | None) -> dict[str, list[str]]:
    """["global=features", "user=userFeatures,features"] -> shard -> bags."""
    if not specs:
        return {"features": ["features"]}
    out: dict[str, list[str]] = {}
    for spec in specs:
        if "=" not in spec:
            raise ValueError(
                f"bad shard spec {spec!r}; expected shard=bag[,bag...]")
        shard, bags = spec.split("=", 1)
        out[shard.strip()] = [b.strip() for b in bags.split(",") if b.strip()]
    return out


def build_shard_vocabularies(
    records, shard_bags: dict[str, list[str]]
) -> dict[str, list[tuple[str, str]]]:
    """Distinct (name, term) pairs per shard, sorted — the NameAndTerm set
    (NameAndTermFeatureBagsDriver semantics). ``records`` may be any
    iterable (including a streaming block decoder): one pass collects every
    shard's set, so peak memory is the vocabularies themselves, never a
    record list."""
    seen: dict[str, set] = {shard: set() for shard in shard_bags}
    for rec in records:
        for shard, bags in shard_bags.items():
            ks = seen[shard]
            for bag in bags:
                for ntv in rec.get(bag) or ():
                    ks.add((ntv["name"], ntv["term"]))
    return {shard: sorted(ks) for shard, ks in seen.items()}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="photon_tpu_torch.cli.index", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    parser.add_argument("--input", required=True, nargs="+",
                        help="Avro data files/dirs to scan")
    parser.add_argument("--output", required=True,
                        help="output directory for index maps + whitelists")
    parser.add_argument("--shards", nargs="*", default=None,
                        help="shard=bag[,bag...] specs; default "
                             "'features=features'")
    parser.add_argument("--no-intercept", action="store_true",
                        help="do not reserve an intercept slot")
    parser.add_argument("--hashed", action="store_true",
                        help="write npz-backed hashed index maps (the "
                             "PalDB analog for multi-million-feature "
                             "vocabularies)")
    parser.add_argument("--verbose", action="store_true")
    args = parser.parse_args(argv)
    logging.basicConfig(
        level=logging.INFO if args.verbose else logging.WARNING)
    log = logging.getLogger("photon.index")

    from photon_tpu_torch.data.index_map import HashedIndexMap, IndexMap
    from photon_tpu_torch.io import avro
    from photon_tpu_torch.types import make_feature_key

    shard_bags = parse_shard_spec(args.shards)

    def stream():
        found = False
        for path in args.input:
            for rec in avro.iter_container_dir(path):
                found = True
                yield rec
        if not found:
            raise ValueError(f"no records in {args.input}")

    vocabularies = build_shard_vocabularies(stream(), shard_bags)
    os.makedirs(args.output, exist_ok=True)
    summary = {}
    for shard, pairs in vocabularies.items():
        keys = [make_feature_key(n, t) for n, t in pairs]
        if args.hashed:
            imap = HashedIndexMap.from_feature_names(
                keys, add_intercept=not args.no_intercept)
            imap.save(os.path.join(args.output, f"{shard}.index.npz"))
        else:
            imap = IndexMap.from_feature_names(
                keys, add_intercept=not args.no_intercept)
            imap.save(os.path.join(args.output, f"{shard}.index.json"))
        # Reference feature-lists format: "name<TAB>term" per line.
        with open(os.path.join(args.output, shard), "w") as f:
            for n, t in pairs:
                f.write(f"{n}\t{t}\n")
        summary[shard] = len(imap)
        log.info("shard %s: %d features", shard, len(imap))
    print(json.dumps({"output": args.output, "shards": summary}))
    return 0


def load_index_maps(directory: str) -> dict[str, "object"]:
    """Load every ``<shard>.index.json`` / ``<shard>.index.npz`` under a
    ``photon index`` output dir (the train/score-side counterpart of
    PalDBIndexMapLoader; npz maps decompress into compact numpy arrays —
    tens of bytes per feature instead of per-entry Python objects)."""
    from photon_tpu_torch.data.index_map import HashedIndexMap, IndexMap

    out = {}
    for name in sorted(os.listdir(directory)):
        if name.endswith(".index.json"):
            out[name[: -len(".index.json")]] = IndexMap.load(
                os.path.join(directory, name)
            )
        elif name.endswith(".index.npz"):
            out[name[: -len(".index.npz")]] = HashedIndexMap.load(
                os.path.join(directory, name)
            )
    if not out:
        raise ValueError(f"no *.index.json / *.index.npz files under "
                         f"{directory}")
    return out


if __name__ == "__main__":
    sys.exit(main())
