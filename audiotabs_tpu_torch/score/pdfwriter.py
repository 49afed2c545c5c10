"""Dependency-free PDF lead-sheet engraver.

The reference renders `score.pdf` by shelling out to the LilyPond binary
(reference: backend/app/services/engraving/lilypond.py:318-336); that
binary does not exist in this environment, so the artifact contract's
`score.pdf` is produced here instead: a Real-Book-style slash-notation
lead sheet — chord symbols over slash noteheads, 4 bars per system,
rehearsal marks every 8 bars — drawn directly with PDF graphics
primitives (the same layout `frontend/score_renderer.js` draws in SVG).
Uses only the base-14 Helvetica fonts, so no font embedding is needed.

`render_pdf_lead_sheet` is the drop-in fallback for
`lilypond.render_lilypond_pdf` when the binary is absent.

The port's copy of ``audiotabs_tpu/score/pdfwriter.py``: host code, arithmetic unchanged.
"""

from __future__ import annotations

from pathlib import Path

from ..theory.vocabulary import split_chord_label
from .lilypond import _chords_per_measure

PAGE_W, PAGE_H = 612.0, 792.0  # US Letter, points
MARGIN = 46.0
STAFF_GAP = 8.0  # distance between staff lines
SYSTEM_H = 72.0  # vertical space per system
BARS_PER_SYSTEM = 4

_QUALITY_TEXT = {
    "maj": "", "min": "m", "7": "7", "maj7": "maj7", "min7": "m7",
    "dim": "dim", "dim7": "dim7", "min7b5": "m7b5", "aug": "aug",
    "sus2": "sus2", "sus4": "sus4", "6": "6", "min6": "m6",
    "9": "9", "maj9": "maj9", "min9": "m9", "add9": "add9",
}


def chord_text(label: str) -> str:
    """'G:min7' → 'Gm7'; 'N' → ''."""
    root, quality, bass = split_chord_label(label)
    if root is None:
        return ""
    txt = root + _QUALITY_TEXT.get(quality or "maj", quality or "")
    if bass:
        txt += f"/{bass}"
    return txt


def _esc(s: str) -> str:
    return s.replace("\\", r"\\").replace("(", r"\(").replace(")", r"\)")


class _Pdf:
    """Minimal multi-page PDF builder (base-14 fonts, vector ops)."""

    def __init__(self) -> None:
        self.pages: list[list[str]] = []

    def page(self) -> list[str]:
        ops: list[str] = []
        self.pages.append(ops)
        return ops

    @staticmethod
    def text(ops, x, y, s, size=12.0, bold=False, center_w=None):
        font = "/F2" if bold else "/F1"
        if center_w is not None:
            # Helvetica average glyph width ≈ 0.52 em: good enough to center
            x = x + (center_w - 0.52 * size * len(s)) / 2
        ops.append(f"BT {font} {size:.1f} Tf {x:.2f} {y:.2f} Td ({_esc(s)}) Tj ET")

    @staticmethod
    def line(ops, x0, y0, x1, y1, w=0.8):
        ops.append(f"{w:.2f} w {x0:.2f} {y0:.2f} m {x1:.2f} {y1:.2f} l S")

    @staticmethod
    def poly(ops, pts):
        parts = [f"{pts[0][0]:.2f} {pts[0][1]:.2f} m"]
        for x, y in pts[1:]:
            parts.append(f"{x:.2f} {y:.2f} l")
        parts.append("f")
        ops.append(" ".join(parts))

    @staticmethod
    def rect(ops, x, y, w, h, lw=0.9):
        ops.append(f"{lw:.2f} w {x:.2f} {y:.2f} {w:.2f} {h:.2f} re S")

    def tobytes(self) -> bytes:
        objs: list[bytes] = []

        def add(body: bytes) -> int:
            objs.append(body)
            return len(objs)  # 1-based object number

        font1 = add(b"<< /Type /Font /Subtype /Type1 /BaseFont /Helvetica >>")
        font2 = add(b"<< /Type /Font /Subtype /Type1 /BaseFont /Helvetica-Bold >>")
        page_ids = []
        content_ids = []
        for ops in self.pages:
            stream = "\n".join(ops).encode()
            content_ids.append(
                add(b"<< /Length " + str(len(stream)).encode() + b" >>\nstream\n" + stream + b"\nendstream")
            )
        pages_id = len(objs) + len(self.pages) + 1
        for cid in content_ids:
            page_ids.append(
                add(
                    (
                        f"<< /Type /Page /Parent {pages_id} 0 R "
                        f"/MediaBox [0 0 {PAGE_W:.0f} {PAGE_H:.0f}] "
                        f"/Resources << /Font << /F1 {font1} 0 R /F2 {font2} 0 R >> >> "
                        f"/Contents {cid} 0 R >>"
                    ).encode()
                )
            )
        kids = " ".join(f"{p} 0 R" for p in page_ids)
        assert add(
            f"<< /Type /Pages /Kids [{kids}] /Count {len(page_ids)} >>".encode()
        ) == pages_id
        catalog = add(f"<< /Type /Catalog /Pages {pages_id} 0 R >>".encode())

        out = bytearray(b"%PDF-1.4\n%\xe2\xe3\xcf\xd3\n")
        offsets = [0]
        for i, body in enumerate(objs, start=1):
            offsets.append(len(out))
            out += f"{i} 0 obj\n".encode() + body + b"\nendobj\n"
        xref_at = len(out)
        out += f"xref\n0 {len(objs)+1}\n".encode()
        out += b"0000000000 65535 f \n"
        for off in offsets[1:]:
            out += f"{off:010d} 00000 n \n".encode()
        out += (
            f"trailer\n<< /Size {len(objs)+1} /Root {catalog} 0 R >>\n"
            f"startxref\n{xref_at}\n%%EOF\n"
        ).encode()
        return bytes(out)


def _draw_system(pdf, ops, x, y, bar_labels, prev_label, bar_index0, beats_per_bar):
    """One 4-bar system with staff, slashes, chord symbols, rehearsal marks.
    Returns the last label drawn (for change detection across systems)."""
    width = PAGE_W - 2 * MARGIN
    bar_w = width / BARS_PER_SYSTEM
    staff_top = y
    # 5 staff lines
    for i in range(5):
        yy = staff_top - i * STAFF_GAP
        pdf.line(ops, x, yy, x + width, yy, 0.7)
    # barlines
    for b in range(BARS_PER_SYSTEM + 1):
        xx = x + b * bar_w
        pdf.line(ops, xx, staff_top, xx, staff_top - 4 * STAFF_GAP, 0.9)
    mid_y = staff_top - 2 * STAFF_GAP
    last = prev_label
    for b, lbl in enumerate(bar_labels):
        bx = x + b * bar_w
        gi = bar_index0 + b
        # rehearsal mark every 8 bars (boxed letter, reference
        # engraving/lilypond.py:224-232 semantics)
        if gi % 8 == 0:
            letter = chr(65 + (gi // 8) % 26)
            pdf.rect(ops, bx + 1.5, staff_top + 16, 14, 14)
            pdf.text(ops, bx + 1.5, staff_top + 19.5, letter, 10, bold=True, center_w=14)
        # chord symbol when it changes (or at a system start)
        if lbl and lbl != "N" and (lbl != last or b == 0):
            pdf.text(ops, bx + 4, staff_top + 4, chord_text(lbl), 12, bold=True)
        last = lbl
        # slash noteheads: one per beat, parallelogram on the middle line
        for k in range(beats_per_bar):
            sx = bx + bar_w * (k + 0.5) / beats_per_bar
            pdf.poly(
                ops,
                [(sx - 2.2, mid_y - 4.0), (sx + 0.8, mid_y - 4.0),
                 (sx + 2.2, mid_y + 4.0), (sx - 0.8, mid_y + 4.0)],
            )
    return last


def build_pdf_lead_sheet(
    chords,
    *,
    tempo_bpm: float,
    beat_times=None,
    title: str = "Lead Sheet",
    key_signature=None,
    beats_per_bar: int = 4,
) -> bytes:
    """Chord segments → Real-Book-style slash lead sheet as PDF bytes."""
    measures = _chords_per_measure(chords, tempo_bpm, beat_times, beats_per_bar) or ["N"]

    pdf = _Pdf()
    ops = pdf.page()
    # header (first page only)
    pdf.text(ops, MARGIN, PAGE_H - 60, title, 20, bold=True, center_w=PAGE_W - 2 * MARGIN)
    sub = f"quarter = {int(round(tempo_bpm))}"
    if key_signature is not None:
        sub += f"   |   {getattr(key_signature, 'name', '')}"
    sub += f"   |   {beats_per_bar}/4"
    pdf.text(ops, MARGIN, PAGE_H - 78, sub, 10, center_w=PAGE_W - 2 * MARGIN)

    y = PAGE_H - 130
    prev = None
    for i in range(0, len(measures), BARS_PER_SYSTEM):
        if y < MARGIN + 4 * STAFF_GAP:
            ops = pdf.page()
            y = PAGE_H - 70
        prev = _draw_system(
            pdf, ops, MARGIN, y, measures[i : i + BARS_PER_SYSTEM], prev, i, beats_per_bar
        )
        y -= SYSTEM_H
    return pdf.tobytes()


def render_pdf_lead_sheet(
    pdf_path: Path | str,
    chords,
    *,
    tempo_bpm: float,
    beat_times=None,
    title: str = "Lead Sheet",
    key_signature=None,
    beats_per_bar: int = 4,
) -> bool:
    data = build_pdf_lead_sheet(
        chords, tempo_bpm=tempo_bpm, beat_times=beat_times, title=title,
        key_signature=key_signature, beats_per_bar=beats_per_bar,
    )
    Path(pdf_path).write_bytes(data)
    return True
