"""Test cases shared by the tests and the card smoke run."""
