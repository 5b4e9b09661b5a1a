"""The LP relaxation of the bundled MIPLIB 2017 instance."""
