"""No module of the benchmark imports JAX, Flax or the JAX package, by
top-level names compared whole (the port's name begins with the JAX
package's), and the reference imports nothing of the program."""
from __future__ import annotations

import ast

from conftest import REPO

FORBIDDEN = {'jax', 'jaxlib', 'flax', 'stereotracking_tpu'}


def imported_tops(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split('.')[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split('.')[0]


def files(sub=''):
    return sorted((REPO / 'portbench' / sub).rglob('*.py'))


def test_no_jax_anywhere():
    for f in files():
        bad = set(imported_tops(f)) & FORBIDDEN
        assert not bad, (f, bad)


def test_reference_takes_nothing_of_the_program():
    for f in files('reference'):
        tops = set(imported_tops(f))
        assert 'stereotracking_tpu_torch' not in tops, f
        assert not tops & FORBIDDEN, f


def test_whole_names_not_prefixes():
    src = ast.parse('import stereotracking_tpu_torch.models\n'
                    'from stereotracking_tpu.ops import nms\n')
    tops = []
    for node in ast.walk(src):
        if isinstance(node, ast.Import):
            tops += [a.name.split('.')[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            tops.append(node.module.split('.')[0])
    assert set(tops) & FORBIDDEN == {'stereotracking_tpu'}
