"""The port's YAML reader (``rtts_torch/yaml_subset.py``, behind
``rtts_torch.config.load_yaml``) against ``yaml.safe_load``: equal on every
config file, on ``save_config``'s output for each, on a table of scalars
(YAML 1.1's resolution, PyYAML's rules) and on the block and flow layouts
of the subset; a ValueError naming the line on each construct outside it.
"""

import math
import pathlib

import pytest
import yaml

from rtts_torch import config as TC
from rtts_torch.yaml_subset import safe_load
from torch_twin import one_thread  # noqa: F401  (autouse)


ROOT = pathlib.Path(__file__).resolve().parent.parent
CONFIGS = sorted((ROOT / "configs").glob("*.yaml"))


def _same(got, want) -> bool:
    if isinstance(want, float) and math.isnan(want):
        return isinstance(got, float) and math.isnan(got)
    return type(got) is type(want) and got == want


def test_eight_config_files():
    assert len(CONFIGS) == 8


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.name)
def test_config_files_and_their_saved_form_read_alike(path, tmp_path):
    text = path.read_text()
    assert safe_load(text) == yaml.safe_load(text)
    assert TC.load_yaml(path) == yaml.safe_load(text)
    cfg = TC.from_dict(TC.Config, TC.load_yaml(path))
    TC.save_config(cfg, tmp_path / "config.yaml")
    saved = (tmp_path / "config.yaml").read_text()
    assert safe_load(saved) == yaml.safe_load(saved)
    assert TC.from_dict(TC.Config, TC.load_yaml(tmp_path / "config.yaml")) \
        == cfg


SCALARS = [
    # floats need a dot, and an exponent needs a sign
    "2.0e-4", "1.0e-3", "1e-5", "1.0e5", "1e3", "-1.5e+3", "1.", "3.", ".5",
    "0.1_5", "1:30.5", ".inf", "-.inf", "+.inf", ".NaN", ".nan", ".", "-.5",
    # ints: decimal, signed, octal, binary, hex, sexagesimal, underscores
    "0", "-0", "+12", "-12", "007", "08", "0x1F", "0b101", "1_000", "1:30",
    "190:20:30", "0o17", "12abc",
    # bools and nulls in YAML 1.1's spellings, and near misses
    "yes", "Yes", "YES", "no", "No", "NO", "on", "On", "ON", "off", "Off",
    "OFF", "true", "True", "TRUE", "false", "False", "FALSE", "tRUE", "y",
    "n", "null", "Null", "NULL", "nULL", "~", "",
    # strings, plain and quoted
    "kv_lsh_chunk", "a b", "http://x.y/z", "x#y", "it's", "a, b", "-x",
    "'quoted'", "'it''s # not a comment'", '"tab\\tand \\u00e9 \\x41 \\"q\\""',
    '"\\\\ and \\/"', "''", '""', "'yes'", '"1.0"',
]


@pytest.mark.parametrize("scalar", SCALARS)
def test_scalars_resolve_as_pyyaml(scalar):
    doc = f"k: {scalar}  # a comment\n"
    got, want = safe_load(doc)["k"], yaml.safe_load(doc)["k"]
    assert _same(got, want), (scalar, got, want)


LAYOUTS = [
    "", "# only a comment\n", "---\na: 1\n", "a: 1\n...\n",
    "a:\n  b:\n    c: 1\n  d: 2\ne: 3\n", "a:\nb: 2\n", "  a: 1\n  b: 2\n",
    "a: b\n  # a deeper comment\nc: d\n", "a: 1\r\nb: 2\r\n",
    '"quoted key": 1\n', "'k''s': 1\n", "yes: no\n", "1: 2\n", "a : 1\n",
    "a: [1, 2, [3, 4], {x: y}]\n", "a: {b: [1, 2], c: {d: e}, f: }\n",
    "a: {b, c: 1}\n", "a: [local, lsh, local, lsh]\n", "a: {}\nb: []\n",
    "a: [[]]\n", "a: [a b, c d]\n", 'a: {"k":1, "j": [1,2]}\n',
    "a: [1, 2, ]\n", "a: [x:y]\n", "a: {x:y}\n", "a: [a]  # c\n",
    "a: [1,\n    2,\n    3]\nb: 4\n", "a: {b: 1,  # c\n    c: 2}\n",
    "a: [1,\n2]\n", "{a: 1, b: [x, y]}\n", "{a: 1,\nb: 2}\n", "[1, 2]\n",
    "hello\n",
]


@pytest.mark.parametrize("doc", LAYOUTS)
def test_layouts_read_as_pyyaml(doc):
    assert safe_load(doc) == yaml.safe_load(doc)


OUTSIDE = {
    "anchor": ("a: &x 1\nb: *x\n", "anchors", 1),
    "alias": ("a: 1\nb: *x\n", "anchors and aliases", 2),
    "tag": ("a: !!str 1\n", "tags", 1),
    "literal block scalar": ("a: 1\nb: |\n  x\n", "block scalars", 2),
    "folded block scalar": ("a: >\n  x\n", "block scalars", 1),
    "two documents": ("a: 1\n---\nb: 2\n", "several documents", 2),
    "document after end": ("a: 1\n...\nb: 2\n", "several documents", 3),
    "directive": ("%YAML 1.1\n---\na: 1\n", "directives", 1),
    "block sequence": ("a:\n  - 1\n", "block sequences", 2),
    "multi-line plain": ("a: b\n  c\n", "multi-line", 2),
    "multi-line quoted": ("a: 'x\n  y'\n", "quoted scalar", 1),
    "timestamp": ("a: 2020-01-01\n", "timestamps", 1),
    "merge key": ("<<: {a: 1}\n", "merge", 1),
    "complex key": ("? a\n: b\n", "complex keys", 1),
    "tab indentation": ("a:\n\tb: 1\n", "tabs", 2),
    "value on key line": ("a: b: c\n", "mapping value", 1),
    "pair in flow sequence": ("a: [a: b]\n", "mappings inside", 1),
    "unterminated flow": ("a: [1, 2\n", "unterminated", 1),
}


@pytest.mark.parametrize("name", sorted(OUTSIDE))
def test_outside_the_subset_raises_naming_the_line(name, tmp_path):
    doc, what, line = OUTSIDE[name]
    with pytest.raises(ValueError, match=f"^<yaml>:{line}: .*{what}"):
        safe_load(doc)
    (tmp_path / "c.yaml").write_text(doc)
    with pytest.raises(ValueError, match=f"c.yaml:{line}: "):
        TC.load_yaml(tmp_path / "c.yaml")
