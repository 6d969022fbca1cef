"""HetRL scheduler: the paper's search, cost model and simulator (the port's own copies of ``repro.core``; framework-free numpy)."""
