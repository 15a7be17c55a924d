"""GraphViz dot rendering of suffix trees, ported from
``suffix_tpu/tree/dot.py`` (the same string, byte for byte).

Equivalent of the reference's ``stree`` CLI output
(stree_cmd/src/main.rs:79-138): box nodes listing terminal suffix indices,
``$`` edges for internal nodes that also carry terminals, edge labels equal
to path labels (lossy UTF-8 for non-decodable bytes). Works on
``SuffixTree`` and ``ArraySuffixTree`` alike.
"""

from __future__ import annotations

from suffix_torch.tree.stree import Node, SuffixTree


def _label_str(st: SuffixTree, node: Node) -> str:
    b = st.label(node)
    try:
        return b.decode("utf-8")
    except UnicodeDecodeError:
        return repr(list(b))


def _terminals(node: Node) -> str:
    return ", ".join(str(s) for s in node.suffixes)


def _is_only_leaf(node: Node) -> bool:
    return not node.children and bool(node.suffixes)


def to_dot(st: SuffixTree) -> str:
    """Render the tree as a GraphViz digraph string."""
    out: list[str] = []
    out.append("digraph tree {")
    try:
        title = st.text() if isinstance(st.text(), str) else st.text_bytes().decode("utf-8", "replace")
    except UnicodeDecodeError:
        title = repr(st.text_bytes())
    out.append(f'label=<<FONT POINT-SIZE="20">{title}</FONT>>;')
    out.append('labelloc="t";')
    out.append('labeljust="l";')

    counter = [0]

    def render(node: Node, parent_id: int) -> None:
        node_id = counter[0]
        counter[0] += 1
        if _is_only_leaf(node):
            out.append(f'{node_id} [label="{_terminals(node)}", shape=box]')
            label = f"{_label_str(st, node)}$"
        else:
            out.append(f'{node_id} [label=""]')
            if node.has_terminals():
                term_id = counter[0]
                counter[0] += 1
                out.append(f'{term_id} [label="{_terminals(node)}", shape=box]')
                out.append(f'{node_id} -> {term_id} [label="$"]')
            label = _label_str(st, node)
        if parent_id != node_id:
            out.append(f'{parent_id} -> {node_id} [label="{label}"];')
        for child in node.child_nodes():
            render(child, node_id)

    render(st.root(), 0)
    out.append("}")
    return "\n".join(out) + "\n"
