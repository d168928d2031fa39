"""The paper's experiments on the port: Tables 3-5 (paper_tables)
and the Theorem 3.1 envelope (bound_check), with the reference's committed
results (reference)."""
