"""Subpackage of glint_word2vec_torch; mirrors the layout of glint_word2vec_tpu."""
