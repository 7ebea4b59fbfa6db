"""Counterparts of the JAX package's ``exp/`` kernel prototypes.

``screen_kernel_opt`` answers ``exp/screen_kernel_opt.py`` (the Boyer-Moore
screen's variants, K11a and K11b) and ``proto_kernels`` answers
``exp/proto_kernels.py`` (the screen fed by word or block views, K11c, and
the screen -> 4 KiB group gather-verify (K11d) -> offsets path).  Each
module's ``main`` runs the reference's measurement on the card.
"""
