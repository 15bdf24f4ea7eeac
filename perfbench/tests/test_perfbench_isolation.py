"""Nothing under perfbench/ imports JAX, the JAX package or the port's
old bench; the reference imports nothing of the program.  Top-level
names are compared whole: the port's name begins with the JAX
package's."""

import ast
import os

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "horaedb_tpu"}


def imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.module


def sources(sub=""):
    for d, _dirs, files in os.walk(os.path.join(HERE, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_jax_and_no_old_bench():
    for path in sources():
        for name in imports(path):
            assert name.split(".")[0] not in FORBIDDEN, (path, name)
            assert not name.startswith("horaedb_tpu_torch.bench"), \
                (path, name)


def test_reference_imports_nothing_of_the_program():
    for path in sources("reference"):
        for name in imports(path):
            assert name.split(".")[0] != "horaedb_tpu_torch", (path, name)
