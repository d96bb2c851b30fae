"""PERF.md's table of the reference's Pallas kernels and their ports
(section 6) stays whole: every row gives a bound, and a library time or
"none" with its reason in brackets; every function of the reference that
reaches `pl.pallas_call` has a row."""
import pathlib
import re

ROOT = pathlib.Path(__file__).resolve().parents[1]
HEADER = "| # | TPU function"


def _rows():
    lines = (ROOT / "PERF.md").read_text().splitlines()
    start = next(i for i, line in enumerate(lines) if line.startswith(HEADER))
    rows = []
    for line in lines[start + 2:]:
        if not line.startswith("|"):
            break
        rows.append([cell.strip() for cell in line.split("|")[1:-1]])
    return lines[start], rows


def test_every_row_has_a_bound_and_a_library_time_or_a_reason():
    header, rows = _rows()
    names = [cell.strip() for cell in header.split("|")[1:-1]]
    bound, library = names.index("bound ms"), names.index("library ms")
    assert len(rows) >= 15
    for row in rows:
        assert len(row) == len(names), row[:2]
        assert re.search(r"\d", row[bound]), row[:2]
        lib = row[library]
        assert re.search(r"\d", lib) or re.fullmatch(r"none \(.+\)", lib), \
            (row[:2], lib)


def test_each_pallas_call_has_its_row():
    sites = [(path.relative_to(ROOT / "src" / "repro").as_posix(), n)
             for path in sorted((ROOT / "src" / "repro").rglob("*.py"))
             for n, line in enumerate(path.read_text().splitlines(), 1)
             if "pl.pallas_call(" in line]
    assert len(sites) >= 13
    _, rows = _rows()
    for path, line in sites:
        assert any(f"`{path}::" in row[1] and f":{line}" in row[1]
                   for row in rows), (path, line)
