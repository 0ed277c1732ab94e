"""Native BAM (BGZF) reader — no htslib/pysam.

The reference ingests alignments through pysam.AlignmentFile, which accepts
SAM or BAM (read_analysis.py:192-198 passes minimap2|samtools BAM output;
users may also supply pre-computed `-ga`/`-ta` alignments).  This module
gives the characterization pipeline the same ingestion surface: BGZF is a
sequence of concatenated gzip members, which Python's GzipFile decodes
transparently, and the BAM record layout is parsed directly per the SAM v1
spec.  Records are surfaced as `sam.SamRecord` (with a synthesized SAM text
line so pass-through writers keep working), making every downstream stage
format-agnostic.
"""

from __future__ import annotations

import gzip
import struct

_MAGIC = b"BAM\x01"
_CIGAR_OPS = "MIDNSHP=X"
_SEQ_NIBBLE = "=ACMGRSVTWYHKDBN"


def is_bam(path: str) -> bool:
    """True when the file is a BGZF-compressed BAM."""
    with open(path, "rb") as f:
        head = f.read(2)
    if head != b"\x1f\x8b":
        return False
    try:
        with gzip.open(path, "rb") as g:
            return g.read(4) == _MAGIC
    except OSError:
        return False


class _Stream:
    def __init__(self, fp):
        self.fp = fp

    def read_exact(self, n: int) -> bytes:
        buf = self.fp.read(n)
        if len(buf) != n:
            raise EOFError(f"truncated BAM stream (wanted {n}, got {len(buf)})")
        return buf

    def read_maybe(self, n: int) -> bytes:
        return self.fp.read(n)


def _parse_tags(buf: bytes):
    """Binary optional fields -> (dict, SAM-text tag fields)."""
    tags = {}
    texts = []
    i = 0
    n = len(buf)
    while i < n:
        tag = buf[i : i + 2].decode("ascii")
        typ = chr(buf[i + 2])
        i += 3
        if typ == "A":
            val = chr(buf[i])
            i += 1
            texts.append(f"{tag}:A:{val}")
        elif typ in "cCsSiI":
            fmt, size = {"c": ("b", 1), "C": ("B", 1), "s": ("h", 2),
                         "S": ("H", 2), "i": ("i", 4), "I": ("I", 4)}[typ]
            val = struct.unpack_from("<" + fmt, buf, i)[0]
            i += size
            texts.append(f"{tag}:i:{val}")
        elif typ == "f":
            val = struct.unpack_from("<f", buf, i)[0]
            i += 4
            texts.append(f"{tag}:f:{val}")
        elif typ in "ZH":
            end = buf.index(0, i)
            val = buf[i:end].decode("ascii", "replace")
            i = end + 1
            texts.append(f"{tag}:{typ}:{val}")
        elif typ == "B":
            sub = chr(buf[i])
            cnt = struct.unpack_from("<i", buf, i + 1)[0]
            fmt, size = {"c": ("b", 1), "C": ("B", 1), "s": ("h", 2),
                         "S": ("H", 2), "i": ("i", 4), "I": ("I", 4),
                         "f": ("f", 4)}[sub]
            val = list(struct.unpack_from(f"<{cnt}{fmt}", buf, i + 1 + 4))
            i += 1 + 4 + cnt * size
            texts.append(f"{tag}:B:{sub}," + ",".join(str(v) for v in val))
        else:
            raise ValueError(f"unknown BAM tag type {typ!r} for {tag}")
        tags[tag] = val
    return tags, texts


def read_bam(path: str):
    """Yield ('header', line) / ('aln', SamRecord) like sam.read_sam."""
    from . import sam as sam_mod

    with gzip.open(path, "rb") as fp:
        s = _Stream(fp)
        if s.read_exact(4) != _MAGIC:
            raise ValueError(f"{path}: not a BAM file")
        (l_text,) = struct.unpack("<i", s.read_exact(4))
        text = s.read_exact(l_text).decode("ascii", "replace").rstrip("\x00")
        for line in text.splitlines():
            if line:
                yield "header", line
        (n_ref,) = struct.unpack("<i", s.read_exact(4))
        refs = []
        sq_seen = "@SQ" in text
        for _ in range(n_ref):
            (l_name,) = struct.unpack("<i", s.read_exact(4))
            name = s.read_exact(l_name)[:-1].decode("ascii")
            (l_ref,) = struct.unpack("<i", s.read_exact(4))
            refs.append((name, l_ref))
            if not sq_seen:
                yield "header", f"@SQ\tSN:{name}\tLN:{l_ref}"

        while True:
            head = s.read_maybe(4)
            if len(head) == 0:
                return
            if len(head) != 4:
                raise EOFError("truncated BAM record header")
            (block_size,) = struct.unpack("<i", head)
            rec = s.read_exact(block_size)
            (ref_id, pos, l_read_name, mapq, _bin, n_cigar, flag, l_seq,
             _nref, _npos, _tlen) = struct.unpack_from("<iiBBHHHiiii", rec, 0)
            off = 32
            qname = rec[off : off + l_read_name - 1].decode("ascii")
            off += l_read_name
            cig = struct.unpack_from(f"<{n_cigar}I", rec, off)
            off += 4 * n_cigar
            nseq = (l_seq + 1) // 2
            seq_bytes = rec[off : off + nseq]
            off += nseq
            qual_bytes = rec[off : off + l_seq]
            off += l_seq
            tags, tag_texts = _parse_tags(rec[off:block_size])

            cigar = "".join(f"{c >> 4}{_CIGAR_OPS[c & 0xF]}" for c in cig) or "*"
            # long-CIGAR escape: placeholder kSmN CIGAR + real CIGAR in CG:B,I
            if (
                n_cigar == 2
                and (cig[0] & 0xF) == 4
                and (cig[1] & 0xF) == 3
                and isinstance(tags.get("CG"), list)
            ):
                cigar = "".join(
                    f"{c >> 4}{_CIGAR_OPS[c & 0xF]}" for c in tags.pop("CG")
                )
            if l_seq:
                sl = []
                for b in seq_bytes:
                    sl.append(_SEQ_NIBBLE[b >> 4])
                    sl.append(_SEQ_NIBBLE[b & 0xF])
                seq = "".join(sl[:l_seq])
            else:
                seq = "*"
            if l_seq and qual_bytes[:1] != b"\xff":
                qual = bytes(q + 33 for q in qual_bytes).decode("ascii")
            else:
                qual = "*"
            rname = refs[ref_id][0] if 0 <= ref_id < n_ref else "*"
            fields = [qname, str(flag), rname, str(pos + 1), str(mapq),
                      cigar, "*", "0", "0", seq, qual] + tag_texts
            yield "aln", sam_mod.SamRecord(
                qname=qname, flag=flag, rname=rname, pos=pos, mapq=mapq,
                cigar=cigar, seq=seq, qual=qual, tags=tags,
                line="\t".join(fields),
            )


_BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000"
)


def _bgzf_block(payload: bytes) -> bytes:
    """One spec-compliant BGZF block (gzip member with BC/BSIZE extra)."""
    import zlib

    comp = zlib.compress(payload, 6)[2:-4]  # raw deflate
    # header: magic, CM=8, FLG=FEXTRA, MTIME=0, XFL=0, OS=255, XLEN=6,
    # subfield 'BC' SLEN=2 BSIZE=total_block_size-1
    head = struct.pack(
        "<4BIBBHBBHH", 0x1F, 0x8B, 8, 4, 0, 0, 255, 6, 66, 67, 2, 0
    )
    total = len(head) + len(comp) + 8
    head = head[:-2] + struct.pack("<H", total - 1)
    return head + comp + struct.pack("<II", zlib.crc32(payload), len(payload))


def _reg2bin(beg: int, end: int) -> int:
    end -= 1
    for shift, off in ((14, 4681), (17, 585), (20, 73), (23, 9), (26, 1)):
        if beg >> shift == end >> shift:
            return off + (beg >> shift)
    return 0


def _encode_tags(tags: dict) -> bytes:
    out = bytearray()
    for tag, val in tags.items():
        out += tag.encode("ascii")
        if isinstance(val, bool):
            out += b"i" + struct.pack("<i", int(val))
        elif isinstance(val, int):
            out += b"i" + struct.pack("<i", val)
        elif isinstance(val, float):
            out += b"f" + struct.pack("<f", val)
        elif isinstance(val, list):
            sub = "f" if any(isinstance(v, float) for v in val) else "i"
            fmt = {"i": "i", "f": "f"}[sub]
            out += b"B" + sub.encode() + struct.pack(f"<i{len(val)}{fmt}", len(val), *val)
        else:
            out += b"Z" + str(val).encode("ascii") + b"\x00"
    return bytes(out)


def write_bam(path: str, header_lines, records):
    """Write a BGZF BAM from SamRecord-like items (spec-compliant blocks +
    EOF marker, readable by htslib tools)."""
    text = "".join(line + "\n" for line in header_lines)
    refs = []
    for line in header_lines:
        if line.startswith("@SQ"):
            name = ln = None
            for fld in line.split("\t")[1:]:
                if fld.startswith("SN:"):
                    name = fld[3:]
                elif fld.startswith("LN:"):
                    ln = int(fld[3:])
            if name is not None:
                refs.append((name, ln or 0))
    ref_idx = {name: i for i, (name, _) in enumerate(refs)}

    body = bytearray()
    body += _MAGIC
    tb = text.encode("ascii")
    body += struct.pack("<i", len(tb)) + tb
    body += struct.pack("<i", len(refs))
    for name, ln in refs:
        nb = name.encode("ascii") + b"\x00"
        body += struct.pack("<i", len(nb)) + nb + struct.pack("<i", ln)

    op_idx = {op: i for i, op in enumerate(_CIGAR_OPS)}
    nib = {c: i for i, c in enumerate(_SEQ_NIBBLE)}
    for rec in records:
        cig_ops = rec.cigar_ops() if rec.cigar != "*" else []
        cig = b"".join(
            struct.pack("<I", (n << 4) | op_idx[op]) for n, op in cig_ops
        )
        seq = rec.seq if rec.seq != "*" else ""
        l_seq = len(seq)
        sb = bytearray((l_seq + 1) // 2)
        for i, c in enumerate(seq):
            v = nib.get(c.upper(), 15)
            sb[i // 2] |= v << 4 if i % 2 == 0 else v
        if rec.qual != "*" and l_seq:
            qb = bytes(ord(c) - 33 for c in rec.qual)
        else:
            qb = b"\xff" * l_seq
        qn = rec.qname.encode("ascii") + b"\x00"
        ref_id = ref_idx.get(rec.rname, -1)
        end = rec.pos + max(rec.reference_length, 1)
        data = (
            struct.pack(
                "<iiBBHHHiiii", ref_id, rec.pos, len(qn), rec.mapq,
                _reg2bin(max(rec.pos, 0), max(end, 1)), len(cig_ops),
                rec.flag, l_seq, -1, -1, 0,
            )
            + qn + cig + bytes(sb) + qb + _encode_tags(rec.tags)
        )
        body += struct.pack("<i", len(data)) + data

    with open(path, "wb") as f:
        mv = memoryview(bytes(body))
        for i in range(0, len(mv), 60000):
            f.write(_bgzf_block(bytes(mv[i : i + 60000])))
        f.write(_BGZF_EOF)


def read_bam_sq_lengths(path: str) -> dict:
    """Reference name -> length from the BAM binary reference list."""
    with gzip.open(path, "rb") as fp:
        s = _Stream(fp)
        if s.read_exact(4) != _MAGIC:
            raise ValueError(f"{path}: not a BAM file")
        (l_text,) = struct.unpack("<i", s.read_exact(4))
        s.read_exact(l_text)
        (n_ref,) = struct.unpack("<i", s.read_exact(4))
        out = {}
        for _ in range(n_ref):
            (l_name,) = struct.unpack("<i", s.read_exact(4))
            name = s.read_exact(l_name)[:-1].decode("ascii")
            (l_ref,) = struct.unpack("<i", s.read_exact(4))
            out[name] = l_ref
        return out
