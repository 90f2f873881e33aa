"""Utilities: conversion from the JAX package's objects."""
