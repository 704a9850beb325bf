"""Minimal pure-Python FITS writer/reader for photon tables.

The port's own copy of clsim_tpu.tabulator.fits (numpy only, so the port
keeps it without importing the JAX package); it writes byte-identical
files.

Produces the same file structure as the reference's cfitsio-based
WriteFITSFile (private/clsim/tabulator/I3CLSimStepToTableConverter.cxx:593-686),
which is what photospline's table reader consumes:

  * primary HDU: FLOAT_IMG with the (reversed-axis) bin contents
  * ``HIERARCH _i3_<key>`` header keywords (ints and doubles)
  * optional IMAGE extension named ``ERRORS`` with squared weights
  * one 1-D DOUBLE_IMG IMAGE extension per axis named ``EDGES<i>``

No cfitsio/astropy dependency: FITS is 2880-byte blocks of 80-char header
cards followed by big-endian data blocks.
"""

from __future__ import annotations

import numpy as np

BLOCK = 2880
CARD = 80


def _card(key: str, value, comment: str = "") -> bytes:
    """One 80-byte header card."""
    if key == "END":
        s = "END"
    elif key.startswith("HIERARCH"):
        # long/hierarchical keyword convention (cfitsio "hierarch" emit)
        s = f"{key} = {_fmt_value(value)}"
    elif value is None:
        s = f"{key:<8}"
    else:
        s = f"{key:<8}= {_fmt_value(value):>20}"
        if comment:
            s += f" / {comment}"
    if len(s) > CARD:
        raise ValueError(f"FITS card too long: {s!r}")
    return s.ljust(CARD).encode("ascii")


def _fmt_value(v) -> str:
    if isinstance(v, bool):
        return "T" if v else "F"
    if isinstance(v, (int, np.integer)):
        return str(int(v))
    if isinstance(v, (float, np.floating)):
        return repr(float(v))
    if isinstance(v, str):
        return f"'{v:<8}'"
    raise TypeError(f"unsupported FITS value {type(v)}")


def _pad(b: bytes, fill: bytes = b" ") -> bytes:
    n = (-len(b)) % BLOCK
    return b + fill * n


def _image_hdu(data: np.ndarray, *, primary: bool, extname: str = "",
               extra_cards=()) -> bytes:
    if data.dtype == np.float32:
        bitpix = -32
    elif data.dtype == np.float64:
        bitpix = -64
    else:
        raise TypeError(f"unsupported dtype {data.dtype}")
    cards = []
    if primary:
        cards.append(_card("SIMPLE", True, "conforms to FITS standard"))
    else:
        cards.append(_card("XTENSION", "IMAGE", "image extension"))
    cards.append(_card("BITPIX", bitpix))
    cards.append(_card("NAXIS", data.ndim))
    # NAXIS1 is the fastest-varying (last C-order) dimension
    for i, n in enumerate(reversed(data.shape)):
        cards.append(_card(f"NAXIS{i + 1}", n))
    if primary:
        cards.append(_card("EXTEND", True))
    else:
        cards.append(_card("PCOUNT", 0))
        cards.append(_card("GCOUNT", 1))
    if extname:
        cards.append(_card("EXTNAME", extname))
    cards.extend(extra_cards)
    cards.append(_card("END", None))
    header = _pad(b"".join(cards))
    payload = _pad(data.astype(data.dtype.newbyteorder(">")).tobytes(),
                   b"\x00")
    return header + payload


def write_fits(path: str, values: np.ndarray, edges, header: dict,
               errors: np.ndarray = None):
    """Write a photon table FITS file.

    values: n-dim float array (bin contents incl. under/overflow bins);
    edges: list of 1-D arrays (one per axis, data-bin edges);
    header: {key: int|float} written as ``HIERARCH _i3_<key>``;
    errors: optional squared-weights array (same shape as values).
    """
    hcards = [_card(f"HIERARCH _i3_{k}", v) for k, v in header.items()
              if isinstance(v, (int, float, np.integer, np.floating))]
    out = [_image_hdu(np.ascontiguousarray(values, np.float32),
                      primary=True, extra_cards=hcards)]
    if errors is not None:
        out.append(_image_hdu(np.ascontiguousarray(errors, np.float32),
                              primary=False, extname="ERRORS"))
    for i, e in enumerate(edges):
        out.append(_image_hdu(np.ascontiguousarray(e, np.float64),
                              primary=False, extname=f"EDGES{i}"))
    with open(path, "wb") as f:
        f.write(b"".join(out))


def _parse_header(block_iter):
    cards = {}
    raw = b""
    while True:
        block = next(block_iter)
        raw += block
        text = block.decode("ascii", errors="replace")
        done = False
        for i in range(0, len(text), CARD):
            card = text[i:i + CARD]
            key = card[:8].strip()
            if key == "END":
                done = True
                break
            if card.startswith("HIERARCH"):
                name, _, val = card[8:].partition("=")
                cards[name.strip()] = _parse_value(val.strip())
            elif "=" in card[8:10]:
                cards[key] = _parse_value(card[10:].split("/")[0].strip())
        if done:
            break
    return cards


def _parse_value(s: str):
    s = s.strip()
    if s.startswith("'"):
        return s.strip("'").strip()
    if s == "T":
        return True
    if s == "F":
        return False
    try:
        return int(s)
    except ValueError:
        return float(s)


def read_fits(path: str):
    """Read back a photon-table FITS file written by write_fits (or cfitsio
    with the same layout).  Returns (values, edges, header, errors)."""
    with open(path, "rb") as f:
        data = f.read()

    def blocks():
        for off in range(0, len(data), BLOCK):
            yield data[off:off + BLOCK]

    it = blocks()
    values = edges_map = errors = None
    header = {}
    edges_map = {}
    while True:
        try:
            cards = _parse_header(it)
        except StopIteration:
            break
        bitpix = cards["BITPIX"]
        naxis = cards["NAXIS"]
        shape = tuple(cards[f"NAXIS{i + 1}"] for i in range(naxis))[::-1]
        count = int(np.prod(shape)) if shape else 0
        dtype = {-32: ">f4", -64: ">f8"}[bitpix]
        nbytes = count * np.dtype(dtype).itemsize
        nblocks = -(-nbytes // BLOCK) if nbytes else 0
        payload = b"".join(next(it) for _ in range(nblocks))
        arr = np.frombuffer(payload[:nbytes], dtype=dtype).reshape(shape)
        extname = cards.get("EXTNAME", "")
        if values is None and "SIMPLE" in cards:
            values = arr.astype(np.float64)
            header = {k[4:]: v for k, v in cards.items()
                      if k.startswith("_i3_")}
        elif extname == "ERRORS":
            errors = arr.astype(np.float64)
        elif extname.startswith("EDGES"):
            edges_map[int(extname[5:])] = arr.astype(np.float64)
    edges = [edges_map[i] for i in sorted(edges_map)]
    return values, edges, header, errors


def save_table_fits(table, path: str):
    """Write a PhotonTable (tabulator/table.py) as a photospline-layout FITS
    file -- the WriteFITSFile equivalent."""
    write_fits(path, np.asarray(table.values, np.float32),
               [a.bin_edges() for a in table.axes.axes],
               dict(table.header),
               errors=(None if table.weights_sq is None
                       else np.asarray(table.weights_sq, np.float32)))
