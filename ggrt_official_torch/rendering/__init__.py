"""The legacy IBRNet volume-rendering path: rays, projection into the
source views, sampling and alpha compositing."""
