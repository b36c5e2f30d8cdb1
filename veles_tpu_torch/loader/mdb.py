"""Minimal pure-Python LMDB (MDB) environment reader/writer.

Port of ``veles_tpu/loader/mdb.py`` (the port keeps its own copy; an
environment it writes is byte-identical to the reference's).  Ref:
veles/znicz/loader/loader_lmdb.py [M] (SURVEY §2.2) reads Caffe-prepared
LMDB datasets through the ``lmdb`` package; that package (and liblmdb
itself) need not be installed, so this module implements the STABLE
on-disk format directly (LMDB 0.9 data version 1, frozen since 2011 —
the format every Caffe-era dataset uses):

- pages 0/1 are meta pages (magic 0xBEEFC0DE, the live one has the
  higher txnid),
- the main DB is a B-tree of branch/leaf pages; leaf nodes inline
  their values unless F_BIGDATA routes them to contiguous overflow
  pages,
- all integers little-endian, 64-bit pgno/size_t, 4096-byte pages.

Scope: read-only iteration of the MAIN database (what a dataset loader
needs) plus a writer sufficient to author valid environments (fixtures,
exports): single-level B-tree (one leaf root, or one branch root over
leaves), overflow values, correct metas.  Nested/named sub-databases,
DUPSORT and free-list handling are out of scope — Caffe datasets use
none of them.
"""

from __future__ import annotations

import os
import struct

PAGE_SIZE = 4096
PAGEHDRSZ = 16
NODESZ = 8                      # offsetof(MDB_node, mn_data)
MAGIC = 0xBEEFC0DE
DATA_VERSION = 1
P_INVALID = 0xFFFFFFFFFFFFFFFF

P_BRANCH, P_LEAF, P_OVERFLOW, P_META = 0x01, 0x02, 0x04, 0x08
F_BIGDATA = 0x01


class MDBFormatError(ValueError):
    pass


def _data_path(path):
    """Accept either the env directory (subdir mode, what ``lmdb.open``
    defaults to and Caffe uses) or a direct file path."""
    if os.path.isdir(path):
        return os.path.join(path, "data.mdb")
    return path


# ------------------------------------------------------------------ reader
class Env:
    """Read-only minimal LMDB environment.

    ``items()`` yields (key, value) bytes in key order — the complete
    API a dataset converter/loader needs; ``entries`` mirrors
    ``lmdb.Environment.stat()["entries"]``.
    """

    def __init__(self, path):
        import mmap
        self._file = open(_data_path(path), "rb")
        try:
            try:
                # memory-map, exactly like liblmdb: an ImageNet-scale env
                # must not be slurped into RAM to read its first Datum
                self._map = mmap.mmap(self._file.fileno(), 0,
                                      access=mmap.ACCESS_READ)
            except ValueError:    # empty file: mmap(0) is illegal
                self._map = b""
            if len(self._map) < 2 * PAGE_SIZE:
                raise MDBFormatError("file too small for LMDB meta pages")
            metas = []
            for i in (0, 1):
                base = i * PAGE_SIZE + PAGEHDRSZ
                magic, version = struct.unpack_from("<II", self._map, base)
                if magic != MAGIC:
                    continue
                if version != DATA_VERSION:
                    raise MDBFormatError("unsupported MDB data version %d"
                                         % version)
                main_db = base + 24 + 48  # skip address+mapsize, FREE db
                (entries,) = struct.unpack_from("<Q", self._map,
                                                main_db + 32)
                (root,) = struct.unpack_from("<Q", self._map, main_db + 40)
                (txnid,) = struct.unpack_from("<Q", self._map,
                                              base + 24 + 2 * 48 + 8)
                metas.append((txnid, root, entries))
            if not metas:
                raise MDBFormatError("no valid LMDB meta page (bad magic)")
            _, self._root, self.entries = max(metas)
        except Exception:
            self.close()          # a failed open must not leak the fd
            raise

    def close(self):
        """Release the mmap and file handle (mirrors
        ``lmdb.Environment.close``); safe to call twice.  A long-lived
        training process should not pin an ImageNet-scale map after the
        splits are copied out."""
        m, f = getattr(self, "_map", b""), getattr(self, "_file", None)
        self._map, self._file = b"", None
        if not isinstance(m, bytes):
            m.close()
        if f is not None:
            f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def stat(self):
        return {"entries": self.entries}

    # -- page walk
    def _page(self, pgno):
        off = pgno * PAGE_SIZE
        if off + PAGE_SIZE > len(self._map):
            raise MDBFormatError("page %d beyond end of map" % pgno)
        return off

    def _iter_page(self, pgno):
        off = self._page(pgno)
        flags, lower = struct.unpack_from("<HH", self._map, off + 10)
        nkeys = (lower - PAGEHDRSZ) >> 1
        for i in range(nkeys):
            (ptr,) = struct.unpack_from("<H", self._map,
                                        off + PAGEHDRSZ + 2 * i)
            node = off + ptr
            lo, hi, nflags, ksize = struct.unpack_from(
                "<HHHH", self._map, node)
            key = self._map[node + NODESZ:node + NODESZ + ksize]
            if flags & P_BRANCH:
                child = lo | (hi << 16) | (nflags << 32)
                yield from self._iter_page(child)
            elif flags & P_LEAF:
                dsize = lo | (hi << 16)
                if nflags & F_BIGDATA:
                    (ovf,) = struct.unpack_from(
                        "<Q", self._map, node + NODESZ + ksize)
                    data_off = self._page(ovf) + PAGEHDRSZ
                    value = self._map[data_off:data_off + dsize]
                else:
                    data = node + NODESZ + ksize
                    value = self._map[data:data + dsize]
                yield key, value
            else:
                raise MDBFormatError("page %d has no branch/leaf flag "
                                     "(flags=%#x)" % (pgno, flags))

    def items(self):
        if self._root == P_INVALID:
            return
        yield from self._iter_page(self._root)


def open_env(path):
    return Env(path)


# ------------------------------------------------------------------ writer
def _leaf_node(key, value, ovf_pgno=None):
    """Serialized leaf node (+ its even-padded size)."""
    if ovf_pgno is None:
        payload = value
    else:
        payload = struct.pack("<Q", ovf_pgno)
    raw = struct.pack("<HHHH", len(value) & 0xFFFF, len(value) >> 16,
                      F_BIGDATA if ovf_pgno is not None else 0,
                      len(key)) + key + payload
    return raw + b"\0" * (len(raw) & 1)


def _branch_node(key, child_pgno):
    raw = struct.pack("<HHHH", child_pgno & 0xFFFF,
                      (child_pgno >> 16) & 0xFFFF,
                      (child_pgno >> 32) & 0xFFFF, len(key)) + key
    return raw + b"\0" * (len(raw) & 1)


def _page_bytes(pgno, flags, nodes):
    """Assemble one B-tree page from serialized nodes (already sized)."""
    lower = PAGEHDRSZ + 2 * len(nodes)
    upper = PAGE_SIZE - sum(len(n) for n in nodes)
    if lower > upper:
        raise MDBFormatError("page overflow: %d nodes don't fit" %
                             len(nodes))
    ptrs, body, pos = [], [], PAGE_SIZE
    for n in nodes:                  # nodes allocated from the top down
        pos -= len(n)
        ptrs.append(pos)
        body.append((pos, n))
    page = bytearray(PAGE_SIZE)
    struct.pack_into("<QHHHH", page, 0, pgno, 0, flags, lower, upper)
    for i, p in enumerate(ptrs):
        struct.pack_into("<H", page, PAGEHDRSZ + 2 * i, p)
    for pos, n in body:
        page[pos:pos + len(n)] = n
    return bytes(page)


def _meta_bytes(pgno, txnid, root, depth, branch_pages, leaf_pages,
                overflow_pages, entries, last_pg, mapsize):
    page = bytearray(PAGE_SIZE)
    struct.pack_into("<QHHHH", page, 0, pgno, 0, P_META, 0, 0)
    base = PAGEHDRSZ
    struct.pack_into("<II", page, base, MAGIC, DATA_VERSION)
    struct.pack_into("<QQ", page, base + 8, 0, mapsize)
    # FREE_DBI: empty
    struct.pack_into("<IHHQQQQQ", page, base + 24,
                     0, 0, 0, 0, 0, 0, 0, P_INVALID)
    # MAIN_DBI
    struct.pack_into("<IHHQQQQQ", page, base + 24 + 48,
                     0, 0, depth, branch_pages, leaf_pages,
                     overflow_pages, entries, root)
    struct.pack_into("<QQ", page, base + 24 + 2 * 48, last_pg, txnid)
    return bytes(page)


def write_env(path, items, subdir=True):
    """Author a valid LMDB environment holding ``items`` (an iterable of
    (key, value) byte pairs) in the MAIN database.

    Values too large to inline (> ~1/2 page, LMDB's nodespill rule
    simplified) go to contiguous overflow pages exactly as liblmdb lays
    them out.  One leaf root, or one branch root over up to ~250 leaves
    (millions of entries are out of scope for a fixture writer).
    """
    items = sorted((bytes(k), bytes(v)) for k, v in items)
    next_pg = 2                       # 0/1 are metas
    pages = {}                        # pgno -> bytes (non-meta)
    ovf_pages = 0

    # overflow values first: every value that can't share a leaf page
    max_inline = (PAGE_SIZE - PAGEHDRSZ) // 2 - NODESZ - 2
    nodes = []
    for key, value in items:
        if NODESZ + len(key) + len(value) > max_inline:
            npages = (PAGEHDRSZ + len(value) + PAGE_SIZE - 1) // PAGE_SIZE
            blob = bytearray(npages * PAGE_SIZE)
            struct.pack_into("<QHHI", blob, 0, next_pg, 0, P_OVERFLOW,
                             npages)
            blob[PAGEHDRSZ:PAGEHDRSZ + len(value)] = value
            for i in range(npages):
                pages[next_pg + i] = bytes(
                    blob[i * PAGE_SIZE:(i + 1) * PAGE_SIZE])
            nodes.append((key, _leaf_node(key, value, ovf_pgno=next_pg)))
            next_pg += npages
            ovf_pages += npages
        else:
            nodes.append((key, _leaf_node(key, value)))

    # pack leaves greedily in key order
    leaves, cur, cur_sz = [], [], PAGEHDRSZ
    for key, raw in nodes:
        if cur and cur_sz + 2 + len(raw) > PAGE_SIZE:
            leaves.append(cur)
            cur, cur_sz = [], PAGEHDRSZ
        cur.append((key, raw))
        cur_sz += 2 + len(raw)
    if cur or not leaves:
        leaves.append(cur)

    leaf_pgnos = []
    for leaf in leaves:
        pages[next_pg] = _page_bytes(next_pg, P_LEAF,
                                     [raw for _, raw in leaf])
        leaf_pgnos.append(next_pg)
        next_pg += 1

    if len(leaves) == 1:
        root, depth, branch_pages = leaf_pgnos[0], 1, 0
        if not items:
            root, depth = P_INVALID, 0
    else:
        bnodes = []
        for i, (leaf, pgno) in enumerate(zip(leaves, leaf_pgnos)):
            # first branch key is implicit/empty, as liblmdb writes it
            key = b"" if i == 0 else leaf[0][0]
            bnodes.append(_branch_node(key, pgno))
        pages[next_pg] = _page_bytes(next_pg, P_BRANCH, bnodes)
        root, depth, branch_pages = next_pg, 2, 1
        next_pg += 1

    mapsize = max(1 << 20, next_pg * PAGE_SIZE)
    out = _data_path(path) if not subdir or os.path.isdir(path) else None
    if subdir:
        os.makedirs(path, exist_ok=True)
        out = os.path.join(path, "data.mdb")
    blob = bytearray(next_pg * PAGE_SIZE)
    blob[0:PAGE_SIZE] = _meta_bytes(0, 0, P_INVALID, 0, 0, 0, 0, 0, 1,
                                    mapsize)
    blob[PAGE_SIZE:2 * PAGE_SIZE] = _meta_bytes(
        1, 1, root, depth, branch_pages, len(leaf_pgnos), ovf_pages,
        len(items), next_pg - 1, mapsize)
    for pgno, page in pages.items():
        blob[pgno * PAGE_SIZE:(pgno + 1) * PAGE_SIZE] = page
    with open(out, "wb") as f:
        f.write(blob)
    return out
