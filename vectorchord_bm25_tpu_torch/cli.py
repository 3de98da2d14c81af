"""Command-line interface: build / search / evaluate / maintain / inspect
(counterpart of ``vectorchord_bm25_tpu/cli.py``, serving on a torch device).

    python -m vectorchord_bm25_tpu_torch.cli build   --input corpus.jsonl --index ./idx
    python -m vectorchord_bm25_tpu_torch.cli search  --index ./idx --query "..." -k 10
    python -m vectorchord_bm25_tpu_torch.cli insert  --index ./idx --text "..." --payload 42
    python -m vectorchord_bm25_tpu_torch.cli delete  --index ./idx --payload 42
    python -m vectorchord_bm25_tpu_torch.cli maintain --index ./idx
    python -m vectorchord_bm25_tpu_torch.cli inspect --index ./idx

Every command serves on ``--device``, given before the command name:
``cuda`` unless ``VCBM25_DEVICE`` names another; a CPU run asks for
``--device cpu``.  A CUDA device on a machine where torch sees no card
fails before anything is read or written: the port never picks a device
on its own (``utils/device.py``).

Corpus format: JSON lines with {"id": int, "text": str} (or plain text,
one doc per line).  The `inspect` command is the bm25_page_inspect debug
analog (SURVEY.md §5).  The commands print the reference CLI's lines, so
either package's CLI reads the other's checkpoints and prints the same.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def _load_corpus(path: str):
    payloads, texts = [], []
    with open(path) as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            if line.startswith("{"):
                rec = json.loads(line)
                payloads.append(int(rec.get("id", i)))
                texts.append(rec["text"])
            else:
                payloads.append(i)
                texts.append(line)
    return payloads, texts


def _engine_opts(args):
    if args.engine == "stream" and args.strategy != "auto":
        return {"strategy": args.strategy}
    return None


def cmd_build(args):
    from .index.bm25index import Bm25Index
    from .index.storage import save_index
    from .text.corpus import documents_from_texts
    from .text.intern import random_seed
    from .utils.options import IndexOptions, SearchOptions

    payloads, texts = _load_corpus(args.input)
    seed = random_seed()
    print(f"ingesting {len(texts)} documents...", file=sys.stderr)
    options = IndexOptions(k1=args.k1, b=args.b)
    if args.workers > 1:
        # Multi-process out-of-core build through disk-spilled sorted runs
        # (the reference's parallel CREATE INDEX path); the workers are
        # spawned and touch no device.
        from .parallel.hostbuild import build_out_of_core

        sealed = build_out_of_core(
            texts, seed, payloads=payloads, options=options,
            n_workers=args.workers,
        )
        index = Bm25Index(
            sealed, seed, options,
            SearchOptions(limit=args.limit), engine=args.engine,
            engine_options=_engine_opts(args), device=args.device,
        )
    else:
        docs = documents_from_texts(seed, texts)
        index = Bm25Index.build(
            docs,
            payloads=payloads,
            options=options,
            search_options=SearchOptions(limit=args.limit),
            seed=seed,
            engine=args.engine,
            engine_options=_engine_opts(args),
            device=args.device,
        )
    save_index(index, args.index)
    print(
        f"built: {index.sealed.n_docs} docs, {index.sealed.n_tokens} terms, "
        f"{index.sealed.n_blocks} blocks -> {args.index}"
    )


def cmd_search(args):
    from .index.storage import load_index
    from .text.intern import Query
    from .text.tokenizer import tsvector

    index = load_index(args.index, device=args.device)
    query = Query.from_tokens(index.seed, tsvector(args.query).keys())
    hits = index.search(query, k=args.k)
    for rank, hit in enumerate(hits, 1):
        print(f"{rank}\t{hit.payload}\t{hit.score:.6f}")


def cmd_insert(args):
    # WAL-backed: the insert is fsynced to wal.log and acknowledged
    # without rewriting the checkpoint (O(1) per insert).
    from .index.storage import open_index
    from .text.corpus import document_from_counts
    from .text.tokenizer import tsvector

    index = open_index(args.index, device=args.device)
    doc = document_from_counts(index.seed, tsvector(args.text))
    index.insert(doc, args.payload)
    print(f"inserted payload {args.payload}")


def cmd_delete(args):
    from .index.storage import open_index

    index = open_index(args.index, device=args.device)
    count = index.bulkdelete_payloads([args.payload])
    print(f"deleted {count} documents")


def cmd_maintain(args):
    from .index.storage import open_index, save_index

    index = open_index(args.index, device=args.device)
    before = len(index.growing)
    index.maintain()
    # Checkpoint after the merge so the WAL stays short.
    save_index(index, args.index)
    print(
        f"maintain done: merged {before} growing docs; sealed now "
        f"{index.sealed.n_docs} docs"
    )


def cmd_inspect(args):
    from .index.storage import load_index

    index = load_index(args.index, device=args.device)
    seg = index.sealed
    info = {
        "n_docs": seg.n_docs,
        "n_live": index.n_docs,
        "n_tokens": seg.n_tokens,
        "n_blocks": seg.n_blocks,
        "sum_dl": seg.sum_dl,
        "avgdl": round(seg.avgdl, 3),
        "options": {"k1": seg.options.k1, "b": seg.options.b},
        "growing_docs": len(index.growing),
        "deleted_sealed": int(index.deleted.sum()),
        "engine": index.engine_kind,
        "sealed_bytes": seg.memory_bytes(),
    }
    from .index.ranges import build_range_index
    from .text.intern import intern

    ri = build_range_index(seg)
    info["range_index_bytes"] = ri.memory_bytes()
    info["bytes_per_posting"] = round(
        ri.memory_bytes() / max(1, ri.post_local.size - ri.range_size), 2
    )
    if args.token is not None:
        tid = seg.lookup_tokens(intern(index.seed, args.token))
        if tid >= 0:
            info["token"] = {
                "id": int(tid),
                "df": int(seg.token_df[tid]),
                "blocks": len(seg.token_blocks(int(tid))),
                "wand_fieldnorm": int(seg.token_wand_fn[tid]),
                "wand_tf": int(seg.token_wand_tf[tid]),
            }
        else:
            info["token"] = None
    print(json.dumps(info, indent=1))


def main(argv=None):
    parser = argparse.ArgumentParser(prog="vectorchord-bm25-tpu-torch")
    parser.add_argument(
        "--device",
        default=os.environ.get("VCBM25_DEVICE", "cuda"),
        help="torch device the index serves on (default: cuda, or "
        "VCBM25_DEVICE); never chosen on its own",
    )
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("build", help="build an index from a corpus file")
    p.add_argument("--input", required=True)
    p.add_argument("--index", required=True)
    p.add_argument("--k1", type=float, default=1.2)
    p.add_argument("--b", type=float, default=0.75)
    p.add_argument("--limit", type=int, default=100)
    p.add_argument(
        "--engine",
        choices=["exact", "blockmax", "hybrid", "stream"],
        default="stream",
    )
    p.add_argument(
        "--strategy",
        choices=["auto", "dense", "sparse", "maxscore"],
        default="auto",
        help="stream-engine reduction strategy (persisted with the "
        "index; maxscore = impact-ordered pruning with tiered "
        "exactness certification)",
    )
    p.add_argument("--workers", type=int, default=1)
    p.set_defaults(fn=cmd_build)

    p = sub.add_parser("search", help="top-k search")
    p.add_argument("--index", required=True)
    p.add_argument("--query", required=True)
    p.add_argument("-k", type=int, default=10)
    p.set_defaults(fn=cmd_search)

    p = sub.add_parser("insert", help="insert one document")
    p.add_argument("--index", required=True)
    p.add_argument("--text", required=True)
    p.add_argument("--payload", type=int, required=True)
    p.set_defaults(fn=cmd_insert)

    p = sub.add_parser("delete", help="delete by payload")
    p.add_argument("--index", required=True)
    p.add_argument("--payload", type=int, required=True)
    p.set_defaults(fn=cmd_delete)

    p = sub.add_parser("maintain", help="merge growing segment (vacuum)")
    p.add_argument("--index", required=True)
    p.set_defaults(fn=cmd_maintain)

    p = sub.add_parser("inspect", help="index statistics (debug)")
    p.add_argument("--index", required=True)
    p.add_argument("--token", default=None)
    p.set_defaults(fn=cmd_inspect)

    args = parser.parse_args(argv)
    from .utils.device import as_device

    try:
        # Checked before any file is read or written.
        args.device = as_device(args.device)
    except RuntimeError as exc:
        parser.error(str(exc))
    args.fn(args)


if __name__ == "__main__":
    main()
