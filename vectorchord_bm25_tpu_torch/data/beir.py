"""BEIR-format dataset loader.

The reference's published quality numbers come from BEIR datasets
(trec-covid, webis-touche2020, SciFact; reference README.md:389-402 via
`xhluca/bm25-benchmarks`).  This loader reads the standard BEIR layout:

    <dir>/corpus.jsonl     {"_id": str, "title": str, "text": str}
    <dir>/queries.jsonl    {"_id": str, "text": str}
    <dir>/qrels/test.tsv   query-id \t corpus-id \t score   (tab-separated,
                           optional header row)

so a user can point the bench/eval harness at a real downloaded BEIR
dataset; when none is available (offline environments), the deterministic
generator in data/synthetic.py emits the same layout.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Dict, List

__all__ = ["BeirDataset", "load_beir"]


@dataclass
class BeirDataset:
    name: str
    doc_ids: List[str]
    doc_texts: List[str]
    query_ids: List[str]
    query_texts: List[str]
    # qrels[query_id][doc_id] = graded relevance (> 0 means relevant)
    qrels: Dict[str, Dict[str, int]] = field(default_factory=dict)

    @property
    def n_docs(self) -> int:
        return len(self.doc_ids)

    @property
    def n_queries(self) -> int:
        return len(self.query_ids)

    def save(self, directory: str) -> None:
        """Write the standard BEIR layout."""
        os.makedirs(os.path.join(directory, "qrels"), exist_ok=True)
        with open(os.path.join(directory, "corpus.jsonl"), "w") as f:
            for did, text in zip(self.doc_ids, self.doc_texts):
                f.write(json.dumps({"_id": did, "title": "", "text": text}) + "\n")
        with open(os.path.join(directory, "queries.jsonl"), "w") as f:
            for qid, text in zip(self.query_ids, self.query_texts):
                f.write(json.dumps({"_id": qid, "text": text}) + "\n")
        with open(os.path.join(directory, "qrels", "test.tsv"), "w") as f:
            f.write("query-id\tcorpus-id\tscore\n")
            for qid in self.query_ids:
                for did, rel in self.qrels.get(qid, {}).items():
                    f.write(f"{qid}\t{did}\t{rel}\n")


def load_beir(directory: str, split: str = "test") -> BeirDataset:
    doc_ids: List[str] = []
    doc_texts: List[str] = []
    with open(os.path.join(directory, "corpus.jsonl")) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            doc_ids.append(str(rec["_id"]))
            title = rec.get("title") or ""
            text = rec.get("text") or ""
            doc_texts.append(f"{title} {text}".strip() if title else text)

    query_ids: List[str] = []
    query_texts: List[str] = []
    with open(os.path.join(directory, "queries.jsonl")) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            query_ids.append(str(rec["_id"]))
            query_texts.append(rec["text"])

    qrels: Dict[str, Dict[str, int]] = {}
    qrels_path = os.path.join(directory, "qrels", f"{split}.tsv")
    if os.path.exists(qrels_path):
        with open(qrels_path) as f:
            for line in f:
                parts = line.rstrip("\n").split("\t")
                if len(parts) < 3 or parts[0] in ("query-id", "qid"):
                    continue
                qid, did, rel = parts[0], parts[1], int(parts[2])
                qrels.setdefault(qid, {})[did] = rel
        # BEIR convention: evaluate only queries present in the split's qrels.
        keep = [i for i, q in enumerate(query_ids) if q in qrels]
        query_ids = [query_ids[i] for i in keep]
        query_texts = [query_texts[i] for i in keep]

    return BeirDataset(
        name=os.path.basename(os.path.normpath(directory)),
        doc_ids=doc_ids,
        doc_texts=doc_texts,
        query_ids=query_ids,
        query_texts=query_texts,
        qrels=qrels,
    )
