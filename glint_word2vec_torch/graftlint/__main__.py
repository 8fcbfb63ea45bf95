"""``python -m glint_word2vec_torch.graftlint`` entry point."""

from glint_word2vec_torch.graftlint.engine import main

if __name__ == "__main__":
    raise SystemExit(main())
