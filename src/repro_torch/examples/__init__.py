"""The example scripts of the port: one module per script of the JAX
package's ``examples/`` (``sharded_exec`` is ``launch.sharded_exec``).

Each runs as ``python -m repro_torch.examples.<name>``, takes the
reference script's flags with the same defaults and prints its lines in
the same order.  ``quickstart`` and ``schedule_heterogeneous`` run the
scheduler on the host only; ``serve_batched``, ``trace_obs``,
``train_rl_e2e`` and ``train_rl_elastic`` also take ``--device`` (default
``cuda``: they raise without a card, and run the plain PyTorch path only
with ``--device cpu``).  Each ``jax.random.PRNGKey(n)`` of a reference
script is a ``torch.Generator`` seeded ``n`` here (or a ``seed=n``);
``np.random.default_rng`` draws are the reference's own.  Files land
where the reference writes them, relative to the working directory.
"""
