"""The port's PQL front end parses every query of a corpus to the same
tree as ``pilosa_tpu.pql``, and rejects the same malformed ones."""

import pytest

from pilosa_tpu import pql as jpql
from pilosa_tpu_torch import pql as tpql
from pilosa_tpu_torch.testing import share_cpu_threads

share_cpu_threads()

CORPUS = [
    "Count(Row(f=1))",
    "Count(Row(f=0))Count(Row(f=1))Count(Row(f=2))",
    "Row(f=10)",
    "Row(f=true)",
    'Row(f="key-1")',
    "Intersect(Row(f=1), Row(g=2))",
    "Union()",
    "Union(Row(f=1), Row(f=2), Row(f=3))",
    "Difference(Row(f=1), Row(f=2))",
    "Xor(Row(f=1), Row(g=1))",
    "Not(Row(f=1))",
    "All()",
    "Count(Intersect(Row(f=1), Union(Row(g=0), Not(Row(g=1)))))",
    "TopN(f, n=5)",
    "TopN(f, Row(g=0), n=5)",
    "TopN(field=f, filter=Row(g=0), n=3)",
    "TopN(f, ids=[1, 2, 3])",
    "Set(10, f=1)",
    "Set(10, f=1, 2017-01-02T03:04)",
    "Clear(10, f=1)",
    "Row(amount > 5)",
    "Row(5 < amount <= 10)",
    "Row(amount != -3)",
    "Count(Row(price >= 1.5))",
    "Row(f=1, from=2017-01-01T00:00, to=2018-01-01T00:00)",
    "Rows(f, limit=10)",
    "GroupBy(Rows(a), Rows(b), filter=Row(x=1))",
    "SetRowAttrs(f, 10, color=\"blue\", active=true)",
    "Options(Row(f=1), columnAttrs=true, shards=[0, 2])",
    "  Count( Row( f = 1 ) )  \n Count(Row(g=2))",
    "Row(my-field_2=7)",
    "Sum(Row(f=1), field=amount)",
]

MALFORMED = ["", "Count(", "Row(f=1))", "Row(f=1,)", "Row(!f=1)",
             "Row(f='unterminated)", "Set(1, 2, f=1)", "Row(f=1, f=2)"]


def _tree(call):
    """Package-neutral structure of a parsed call."""
    def val(v):
        if hasattr(v, "children") and hasattr(v, "args"):
            return _tree(v)
        if hasattr(v, "op") and hasattr(v, "value"):
            return ("cond", v.op, val(v.value))
        if isinstance(v, list):
            return [val(x) for x in v]
        return (type(v).__name__, v)
    return (call.name, {k: val(v) for k, v in call.args.items()},
            [_tree(c) for c in call.children])


@pytest.mark.parametrize("src", CORPUS)
def test_same_tree(src):
    want = jpql.parse(src)
    got = tpql.parse(src)
    assert [_tree(c) for c in got.calls] == [_tree(c) for c in want.calls]
    assert str(got) == str(want)
    assert tpql.parse_cached(src).calls == got.calls


@pytest.mark.parametrize("src", MALFORMED)
def test_same_rejections(src):
    with pytest.raises(jpql.ParseError):
        jpql.parse(src)
    with pytest.raises(tpql.ParseError):
        tpql.parse(src)
