"""photon_tpu_torch.serve"""

# Program contract (``python -m photon_tpu_torch.analysis --semantic``):
# the score ladder is one program a rung (one CUDA graph each on the
# card); every request count pads into a rung, and a values-only reload
# re-enters the same programs (coefficients are operands). Nothing in a
# rung syncs.
PROGRAM_AUDIT = dict(
    name="serving",
    entry="serve.programs.ScorePrograms (the score ladder over "
    "serve.tables)",
    builder="build_serving",
    max_programs=3,  # == the builder's ladder rungs
    stable_under=("request_batch", "model_reload"),
    hot_loop=True,
)
